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
// A launch's layout (a runtime argument, uniform over the grid) lets it
// read a level's image in place of its four planes, the split at stride 2
// folded into the gather (K2's SplitGather addresses), and write its four
// outputs as one image, the merge folded into the sink (K3's
// InterleaveSink addresses): the first launch of a forward level and the
// last of an inverse level then need no copy around them.  Both layouts
// go through one strided gather and one strided sink, set per tile:
// choosing between the planar and the image policies inside the walk cost
// K1 9% of its time on the card (PERF.md), the strided pair nothing.
// The walk evaluates the program wave by wave, one barrier per
// dependency wave, keeps intermediate nodes in shared-memory slots and
// writes output nodes from registers, masking the ragged edge.  See
// repro_torch/kernels/tap_window.py for the table encoder, the build and
// the plain version the kernel is held against, and window_common.cuh for
// the table and the walk.
#include "window_common.cuh"

namespace {

using namespace window;

// Layout bits of a launch: the input is one (B, 2hp, 2wp) image at in.p[0]
// (else four planes), the output one image at out.p[0] (else four planes).
constexpr int kImageIn = 1;
constexpr int kImageOut = 2;

// Input policy of a launch: sample (gy, gx) of plane j (mod hp / mod wp at
// the edges) at p[j] + gy * rs + gx * cs: the four planes (rs = wp, cs = 1)
// or the image read as its polyphase planes (p[j] at pixel (j >> 1, j & 1),
// rs = 2W, cs = 2; SplitGather's addresses), so no branch on the layout
// inside the loops.
template <typename T>
struct StridedGather {
  using Idx = size_t;
  const T* p[4];
  size_t rs;
  int cs;
  Geom g;
  __device__ __forceinline__ Idx index(int y, int x) const {
    int gy = g.y0 - g.r + y;
    int gx = g.x0 - g.r + x;
    if (!g.interior) {
      gy = wrap(gy, g.hp);
      gx = wrap(gx, g.wp);
    }
    return static_cast<size_t>(gy) * rs + static_cast<size_t>(gx * cs);
  }
  __device__ __forceinline__ const T* ptr(int j, Idx i) const {
    return p[j] + i;
  }
};

// Output policy of a launch: output k at plane position (gy, gx) of the
// tile core to p[k] + gy * rs + gx * cs, the four planes or the image
// (p[k] at pixel (k >> 1, k & 1), rs = 4wp, cs = 2; InterleaveSink's
// addresses); the ragged edge is masked, as store_core masks it.
template <typename T>
struct StridedSink {
  T* p[4];
  size_t rs;
  int cs;
  Geom g;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    if (y < g.r || y >= g.r + g.bh || x < g.r || x >= g.r + g.bw) return;
    const int gy = g.y0 + y - g.r;
    const int gx = g.x0 + x - g.r;
    if (gy >= g.hp || gx >= g.wp) return;
    const size_t i = static_cast<size_t>(gy) * rs + static_cast<size_t>(gx * cs);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mask & (1 << k)) from_float(p[k] + i, v);
    }
  }
};

template <typename T>
struct LevelTiles {
  InPlanes in;
  OutPlanes out;
  TileGrid grid;
  int n_tiles;
  int layout;
  __device__ __forceinline__ StridedGather<T> gather(int t) const {
    const Geom g = grid.geom(t);
    StridedGather<T> s;
    s.g = g;
    if (layout & kImageIn) {
      const size_t w = 2 * static_cast<size_t>(grid.wp);
      const T* img = static_cast<const T*>(in.p[0]) + g.base * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) s.p[j] = img + (j >> 1) * w + (j & 1);
      s.rs = 2 * w;
      s.cs = 2;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s.p[j] = static_cast<const T*>(in.p[j]) + g.base;
      }
      s.rs = grid.wp;
      s.cs = 1;
    }
    return s;
  }
  __device__ __forceinline__ StridedSink<T> sink(int t) const {
    const Geom g = grid.geom(t);
    StridedSink<T> s;
    s.g = g;
    if (layout & kImageOut) {
      const size_t w = 2 * static_cast<size_t>(grid.wp);
      T* img = static_cast<T*>(out.p[0]) + g.base * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) s.p[k] = img + (k >> 1) * w + (k & 1);
      s.rs = 2 * w;
      s.cs = 2;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) s.p[k] = static_cast<T*>(out.p[k]) + g.base;
      s.rs = grid.wp;
      s.cs = 1;
    }
    return s;
  }
};

template <typename T, int kE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
tap_window_kernel(const int* __restrict__ table, int table_ints,
                  InPlanes in, OutPlanes out, int batch, int hp, int wp,
                  int bh, int bw, int r, int layout) {
  extern __shared__ __align__(16) int smem[];
  for (int i = threadIdx.x; i < table_ints; i += kThreads) smem[i] = table[i];
  __syncthreads();
  const TileGrid grid(batch, hp, wp, bh, bw, r);
  run_tiles<T, kE, kBf16>(
      smem, LevelTiles<T>{in, out, grid, grid.n_tiles, layout});
}

template <typename T, int kE, bool kBf16>
cudaError_t launch(const int* table, int table_ints, const InPlanes& in,
                   const OutPlanes& out, int batch, int hp, int wp, int bh,
                   int bw, int r, int layout, int smem, int device,
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
                                           hp, wp, bh, bw, r, layout);
  return cudaGetLastError();
}

// The walk's positions per thread (the table header's).
template <typename T, bool kBf16>
cudaError_t launch_elems(int elems, const int* table, int table_ints,
                         const InPlanes& in, const OutPlanes& out, int batch,
                         int hp, int wp, int bh, int bw, int r, int layout,
                         int smem, int device, cudaStream_t stream,
                         int* info) {
  switch (elems) {
    case 4:
      return launch<T, 4, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, layout, smem, device, stream,
                                 info);
    case 6:
      return launch<T, 6, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, layout, smem, device, stream,
                                 info);
    case 9:
      return launch<T, 9, kBf16>(table, table_ints, in, out, batch, hp, wp,
                                 bh, bw, r, layout, smem, device, stream,
                                 info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// elems: the walk's positions per thread (4, 6 or 9, the table header's);
// io_dtype: 0 float32, 1 float16, 2 bfloat16; smem: the launch's dynamic
// shared memory in bytes (tap_window.WindowProgram.smem_bytes); layout:
// bit 0 (kImageIn) reads in0 as one (batch, 2hp, 2wp) image and bit 1
// (kImageOut) writes out0 as one such image, the other pointers unused
// (0: four planes in and out); device: the CUDA ordinal the stream
// belongs to; info: receives the grid and the resident blocks per SM (may
// be null).  Returns a cudaError_t.
int tap_window_launch_layout(const int* table, int table_ints,
                             const void* in0, const void* in1,
                             const void* in2, const void* in3, void* out0,
                             void* out1, void* out2, void* out3, int batch,
                             int hp, int wp, int bh, int bw, int r, int smem,
                             int elems, int io_dtype, int bf16_compute,
                             int layout, int device, void* stream,
                             int* info) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (layout < 0 || layout > (kImageIn | kImageOut)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const InPlanes in{{in0, in1, in2, in3}};
  const OutPlanes out{{out0, out1, out2, out3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define TAP_WINDOW_LAUNCH(T)                                                 \
  return static_cast<int>(                                                   \
      bf ? launch_elems<T, true>(elems, table, table_ints, in, out, batch,   \
                                 hp, wp, bh, bw, r, layout, smem, device, s, \
                                 info)                                       \
         : launch_elems<T, false>(elems, table, table_ints, in, out, batch,  \
                                  hp, wp, bh, bw, r, layout, smem, device,   \
                                  s, info))
  switch (io_dtype) {
    case 0: TAP_WINDOW_LAUNCH(float);
    case 1: TAP_WINDOW_LAUNCH(__half);
    case 2: TAP_WINDOW_LAUNCH(__nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TAP_WINDOW_LAUNCH
}

// The plane layout: four planes in, four out (tap_window_launch_layout at
// layout 0).
int tap_window_launch(const int* table, int table_ints,
                      const void* in0, const void* in1, const void* in2,
                      const void* in3, void* out0, void* out1, void* out2,
                      void* out3, int batch, int hp, int wp, int bh, int bw,
                      int r, int smem, int elems, int io_dtype,
                      int bf16_compute, int device, void* stream,
                      int* info) {
  return tap_window_launch_layout(table, table_ints, in0, in1, in2, in3,
                                  out0, out1, out2, out3, batch, hp, wp, bh,
                                  bw, r, smem, elems, io_dtype, bf16_compute,
                                  0, device, stream, info);
}

const char* tap_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
