// Window kernel: one compiled tap program over four polyphase planes.
//
// Replaces the reference package's Pallas window kernel
// kernels/polyphase.py::_steps_pallas_call (K1).  Bound by device-memory
// bytes on an H100 in principle (each launch reads four (B, hp, wp)
// planes and writes four), by the walk of the program table in practice.
// The grid is the number of blocks that fit on the card at once; each
// block loops over (bh x bw) tiles, requesting the next tile's four
// (bh+2r) x (bw+2r) input windows through cp.async as soon as a tile's
// walk ends, straight from the unpadded planes with mod-hp / mod-wp
// indexing at the edges; the other resident blocks compute meanwhile.
// The walk evaluates the program wave by wave, one barrier per
// dependency wave, keeps intermediate nodes in shared-memory slots and
// writes output nodes from registers, masking the ragged edge.  See
// repro_torch/kernels/tap_window.py for the table encoder, the build and
// the plain version the kernel is held against, and window_common.cuh for
// the table and the walk.
#include "window_common.cuh"

namespace {

using namespace window;

// Input policy: the four planes, gathered mod hp / mod wp at the edges.
template <typename T>
struct PlaneGather {
  using Idx = size_t;
  InPlanes in;
  Geom g;
  __device__ __forceinline__ Idx index(int y, int x) const {
    int gy = g.y0 - g.r + y;
    int gx = g.x0 - g.r + x;
    if (!g.interior) {
      gy = wrap(gy, g.hp);
      gx = wrap(gx, g.wp);
    }
    return g.base + static_cast<size_t>(gy) * g.wp + gx;
  }
  __device__ __forceinline__ const T* ptr(int j, Idx i) const {
    return static_cast<const T*>(in.p[j]) + i;
  }
};

template <typename T>
struct PlaneTiles {
  InPlanes in;
  OutPlanes out;
  TileGrid grid;
  int n_tiles;
  __device__ __forceinline__ PlaneGather<T> gather(int t) const {
    return PlaneGather<T>{in, grid.geom(t)};
  }
  __device__ __forceinline__ CoreSink<T> sink(int t) const {
    return CoreSink<T>{out, grid.geom(t)};
  }
};

template <typename T, int kE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
tap_window_kernel(const int* __restrict__ table, int table_ints,
                  InPlanes in, OutPlanes out, int batch, int hp, int wp,
                  int bh, int bw, int r) {
  extern __shared__ __align__(16) int smem[];
  for (int i = threadIdx.x; i < table_ints; i += kThreads) smem[i] = table[i];
  __syncthreads();
  const TileGrid grid(batch, hp, wp, bh, bw, r);
  run_tiles<T, kE, kBf16>(smem, PlaneTiles<T>{in, out, grid, grid.n_tiles});
}

template <typename T, int kE, bool kBf16>
cudaError_t launch(const int* table, int table_ints, const InPlanes& in,
                   const OutPlanes& out, int batch, int hp, int wp, int bh,
                   int bw, int r, int smem, int device,
                   cudaStream_t stream, int* info) {
  auto kernel = tap_window_kernel<T, kE, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(batch) *
                          ((hp + bh - 1) / bh) * ((wp + bw - 1) / bw);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * sms ? tiles
                                                   : per_sm * sms);
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
  }
  kernel<<<grid, kThreads, smem, stream>>>(table, table_ints, in, out, batch,
                                           hp, wp, bh, bw, r);
  return cudaGetLastError();
}

// The walk's positions per thread (the table header's).
template <typename T, bool kBf16>
cudaError_t launch_elems(int elems, const int* table, int table_ints,
                         const InPlanes& in, const OutPlanes& out, int batch,
                         int hp, int wp, int bh, int bw, int r, int smem,
                         int device, cudaStream_t stream, int* info) {
  switch (elems) {
    case 4:
      return launch<T, 4, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, smem, device, stream, info);
    case 6:
      return launch<T, 6, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, smem, device, stream, info);
    case 9:
      return launch<T, 9, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, smem, device, stream, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// elems: the walk's positions per thread (4, 6 or 9, the table header's);
// io_dtype: 0 float32, 1 float16, 2 bfloat16; smem: the launch's dynamic
// shared memory in bytes (tap_window.WindowProgram.smem_bytes); device:
// the CUDA ordinal the stream belongs to; info: receives the grid and the
// resident blocks per SM (may be null).  Returns a cudaError_t.
int tap_window_launch(const int* table, int table_ints,
                      const void* in0, const void* in1, const void* in2,
                      const void* in3, void* out0, void* out1, void* out2,
                      void* out3, int batch, int hp, int wp, int bh, int bw,
                      int r, int smem, int elems, int io_dtype,
                      int bf16_compute, int device, void* stream,
                      int* info) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const InPlanes in{{in0, in1, in2, in3}};
  const OutPlanes out{{out0, out1, out2, out3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define TAP_WINDOW_LAUNCH(T)                                                \
  return static_cast<int>(                                                  \
      bf ? launch_elems<T, true>(elems, table, table_ints, in, out, batch,  \
                                 hp, wp, bh, bw, r, smem, device, s, info)  \
         : launch_elems<T, false>(elems, table, table_ints, in, out, batch, \
                                  hp, wp, bh, bw, r, smem, device, s, info))
  switch (io_dtype) {
    case 0: TAP_WINDOW_LAUNCH(float);
    case 1: TAP_WINDOW_LAUNCH(__half);
    case 2: TAP_WINDOW_LAUNCH(__nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TAP_WINDOW_LAUNCH
}

const char* tap_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
