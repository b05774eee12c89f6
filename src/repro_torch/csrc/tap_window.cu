// Window kernel: one compiled tap program over four polyphase planes.
//
// Replaces the reference package's Pallas window kernel
// kernels/polyphase.py::_steps_pallas_call (K1).  Bound by device-memory
// bytes on an H100: each launch reads four (B, hp, wp) planes and writes
// four.  The block gathers its four (bh+2r) x (bw+2r) input windows
// straight from the unpadded planes with mod-hp / mod-wp indexing (no
// separate periodic-pad pass), keeps every intermediate node of the
// program in a shared-memory slot, and writes output nodes from
// registers, masking the ragged edge.  See
// repro_torch/kernels/tap_window.py for the table encoder, the build and
// the plain version the kernel is held against.
//
// The table walk, the rounding helpers and the masked core store are
// shared with the fused-pyramid kernels (window_common.cuh, which also
// describes the table).  Here the inputs are the four unpadded planes
// and the outputs the four block cores.
#include "window_common.cuh"

namespace {

using namespace window;

// Input policy: the four planes, gathered mod hp / mod wp at the edges.
template <typename T>
struct PlaneSrc {
  using Idx = size_t;
  const InPlanes& in;
  const Geom& g;
  __device__ __forceinline__ Idx index(int y, int x) const {
    int gy = g.y0 - g.r + y;
    int gx = g.x0 - g.r + x;
    if (!g.interior) {
      gy = wrap(gy, g.hp);
      gx = wrap(gx, g.wp);
    }
    return g.base + static_cast<size_t>(gy) * g.wp + gx;
  }
  __device__ __forceinline__ float load(int j, Idx i) const {
    return to_float(static_cast<const T*>(in.p[j])[i]);
  }
};

// Output policy: the block core of the four output planes.
template <typename T>
struct CoreSink {
  const OutPlanes& out;
  const Geom& g;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    store_core<T>(out, mask, g, y, x, v);
  }
};

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
tap_window_kernel(const int* __restrict__ table, int table_ints,
                  InPlanes in, OutPlanes out, int hp, int wp, int bh, int bw,
                  int r) {
  extern __shared__ __align__(16) int smem[];
  for (int i = threadIdx.x; i < table_ints; i += kThreads) smem[i] = table[i];
  float* slots = reinterpret_cast<float*>(smem + ((table_ints + 3) & ~3));
  __syncthreads();

  Geom g;
  g.hp = hp;
  g.wp = wp;
  g.bh = bh;
  g.bw = bw;
  g.r = r;
  g.y0 = blockIdx.y * bh;
  g.x0 = blockIdx.x * bw;
  g.base = static_cast<size_t>(blockIdx.z) * hp * wp;
  g.interior = g.y0 >= r && g.y0 + bh + r <= hp && g.x0 >= r &&
               g.x0 + bw + r <= wp;
  walk<kBf16>(smem, PlaneSrc<T>{in, g}, CoreSink<T>{out, g}, slots,
              bh + 2 * r, bw + 2 * r);
}

template <typename T, bool kBf16>
cudaError_t launch(const int* table, int table_ints, const InPlanes& in, const OutPlanes& out, int batch,
                   int hp, int wp, int bh, int bw, int r, int n_slots,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * static_cast<size_t>((table_ints + 3) & ~3) +
      sizeof(float) * static_cast<size_t>(n_slots) * (bh + 2 * r) *
          (bw + 2 * r);
  auto kernel = tap_window_kernel<T, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((wp + bw - 1) / bw, (hp + bh - 1) / bh, batch);
  kernel<<<grid, kThreads, smem, stream>>>(table, table_ints, in, out, hp,
                                           wp, bh, bw, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// io_dtype: 0 float32, 1 float16, 2 bfloat16; device: the CUDA ordinal
// the stream belongs to.  Returns a cudaError_t.
int tap_window_launch(const int* table, int table_ints,
                      const void* in0, const void* in1, const void* in2,
                      const void* in3, void* out0, void* out1, void* out2,
                      void* out3, int batch, int hp, int wp, int bh, int bw,
                      int r, int n_slots, int io_dtype, int bf16_compute,
                      int device, void* stream) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const InPlanes in{{in0, in1, in2, in3}};
  const OutPlanes out{{out0, out1, out2, out3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define TAP_WINDOW_LAUNCH(T)                                                \
  return static_cast<int>(                                                  \
      bf ? launch<T, true>(table, table_ints, in, out, batch, hp, wp, bh,   \
                           bw, r, n_slots, s)                               \
         : launch<T, false>(table, table_ints, in, out, batch, hp, wp, bh,  \
                            bw, r, n_slots, s))
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
