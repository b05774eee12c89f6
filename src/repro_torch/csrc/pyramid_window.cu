// Fused-pyramid kernels: the whole L-level 2-D DWT in one launch.
//
// Replace the reference package's Pallas kernels
// kernels/polyphase.py::pyramid_forward_pallas (K2) and
// ::pyramid_inverse_pallas (K3).  See repro_torch/kernels/pyramid_window.py
// for the table encoder, the shared-memory guard, the build and the plain
// versions the kernels are held against.
//
// What bounds them on an H100: device-memory bytes in principle (the
// image is read once and every subband written once, 2 x 4 B per pixel
// in float32), but in practice the table walk: level 0 runs the whole-
// chain program over a window that carries the compound margin of all
// levels, several times the block core, and a barrier separates the
// program's nodes.  What the design does about the bytes: nothing but the
// image (forward) or the subbands (inverse) comes from device memory, and
// nothing but the subbands (forward) or the image (inverse) goes back;
// every intermediate LL plane stays in shared memory.
//
// Grid (ceil(W/bw), ceil(H/bh), B) over image-space blocks bh x bw, both
// multiples of 2^L.  Per block and level l (cores bh_l = bh >> l):
//
// K2, finest to coarsest.  Level 0 gathers the four polyphase planes of
// the window straight from the interleaved image, mod H / mod W, in the
// order of the reference's _split: (even row, even col), (even, odd),
// (odd, even), (odd, odd); the window origin sits margins[0] image
// pixels before the block, so its row and column are even.  Level l > 0
// splits the LL window carried in shared memory at stride 2.  Level l
// runs program l with its outputs at margin shrinks[l] inside a window of
// halo R_l = margins[l] / 2 plane samples around the bh_{l+1} x bw_{l+1}
// core; HL/LH/HH go to device memory (core only, ragged edge masked), LL
// goes to the carry rounded through the I/O dtype, or, at the last
// level, to device memory.
//
// K3, coarsest to finest.  Level l gathers the LL window (the carry, or
// at the coarsest level the LL plane) and the level's three detail
// windows with halo margins[l+1], mod each subband's dims; runs program l
// with its outputs at margin shrinks[l]; and interleaves the four outputs
// (out[2i,2j] = y0, [2i,2j+1] = y1, [2i+1,2j] = y2, [2i+1,2j+1] = y3)
// into the carry, rounded through the I/O dtype, or at level 0 into the
// block of the image, ragged edge masked.
//
// Pyramid table (int32, built by pyramid_window.encode_pyramid):
//   header  levels, level_ints, n_slots, slot_floats
//   level   offset of its table, halo, shrink, 0     (4 ints, per level)
//   tables  one window table per level (window_common.cuh), at offset
// Shared memory: the current level's table (level_ints, rounded up to 4),
// n_slots slots of slot_floats each, then the carry.
#include "window_common.cuh"

namespace {

using namespace window;

constexpr int kMaxLevels = 8;
constexpr int kPyrHeader = 4;
constexpr int kLevelInts = 4;

struct PyrPlanes { void* p[1 + 3 * kMaxLevels]; };

// --- K2 policies -----------------------------------------------------------

// Level 0: polyphase plane j of the interleaved image.  Window sample
// (y, x) is image pixel (y0 + 2y + dy, x0 + 2x + dx) with (dy, dx) =
// (j >> 1, j & 1); y0 and x0 are even, and so are H and W, so the wrap of
// the even pixel keeps the phase and the odd one never needs its own.
template <typename T>
struct ImageSrc {
  using Idx = size_t;
  const T* x;
  int h, w, y0, x0;
  size_t base;
  bool interior;
  __device__ __forceinline__ Idx index(int y, int xx) const {
    int gy = y0 + 2 * y;
    int gx = x0 + 2 * xx;
    if (!interior) {
      gy = wrap(gy, h);
      gx = wrap(gx, w);
    }
    return base + static_cast<size_t>(gy) * w + gx;
  }
  __device__ __forceinline__ float load(int j, Idx i) const {
    return to_float(x[i + static_cast<size_t>(j >> 1) * w + (j & 1)]);
  }
};

// Level l > 0: plane j of the carried LL window, split at stride 2.
struct SplitSrc {
  using Idx = int;
  const float* carry;
  int cw;                 // carry width: twice the level's window width
  __device__ __forceinline__ Idx index(int y, int x) const {
    return 2 * y * cw + 2 * x;
  }
  __device__ __forceinline__ float load(int j, Idx i) const {
    return carry[i + (j >> 1) * cw + (j & 1)];
  }
};

// Outputs of level l: HL/LH/HH (bits 1-3) to the block core of the
// level's subbands; LL (bit 0) to the carry over the whole output region
// [s, wh - s) x [s, ww - s), or at the last level to the coarsest LL.
template <typename T, bool kBf16>
struct ForwardSink {
  const OutPlanes& out;   // p[0] = coarsest LL at the last level, else unused
  const Geom& g;
  float* carry;           // nullptr at the last level
  int s, wh, ww;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    if (carry != nullptr && (mask & 1)) {
      if (y >= s && y < wh - s && x >= s && x < ww - s) {
        carry[(y - s) * (ww - 2 * s) + x - s] =
            round_c<kBf16>(round_io<T>(v));
      }
      mask &= ~1;
    }
    if (mask) store_core<T>(out, mask, g, y, x, v);
  }
};

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pyramid_forward_kernel(const int* __restrict__ table,
                       const T* __restrict__ x, PyrPlanes out, int h, int w,
                       int bh, int bw) {
  extern __shared__ __align__(16) int smem[];
  const int levels = table[0];
  const int level_ints = table[1];
  float* slots = reinterpret_cast<float*>(smem + ((level_ints + 3) & ~3));
  float* carry = slots + static_cast<size_t>(table[2]) * table[3];
  int carry_w = 0;
  for (int l = 0; l < levels; ++l) {
    const int* lv = table + kPyrHeader + l * kLevelInts;
    const int* src = table + lv[0];
    const int r = lv[1];
    const int s = lv[2];
    const int n = kHeader + kNodeInts * src[0] + 4 * src[1];
    // the walk of the level before ended on a barrier
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = src[i];
    __syncthreads();
    const bool last = l + 1 == levels;
    Geom g;
    g.hp = h >> (l + 1);
    g.wp = w >> (l + 1);
    g.bh = bh >> (l + 1);
    g.bw = bw >> (l + 1);
    g.r = r;
    g.y0 = blockIdx.y * g.bh;
    g.x0 = blockIdx.x * g.bw;
    g.base = static_cast<size_t>(blockIdx.z) * g.hp * g.wp;
    g.interior = false;   // unused: the level's inputs are not its planes
    const int wh = g.bh + 2 * r;
    const int ww = g.bw + 2 * r;
    const OutPlanes o{{last ? out.p[0] : nullptr, out.p[1 + 3 * l],
                       out.p[2 + 3 * l], out.p[3 + 3 * l]}};
    const ForwardSink<T, kBf16> sink{o, g, last ? nullptr : carry, s, wh,
                                     ww};
    if (l == 0) {
      const int y0 = blockIdx.y * bh - 2 * r;
      const int x0 = blockIdx.x * bw - 2 * r;
      const ImageSrc<T> img{
          x, h, w, y0, x0, static_cast<size_t>(blockIdx.z) * h * w,
          y0 >= 0 && y0 + 2 * wh <= h && x0 >= 0 && x0 + 2 * ww <= w};
      walk<kBf16>(smem, img, sink, slots, wh, ww);
    } else {
      walk<kBf16>(smem, SplitSrc{carry, carry_w}, sink, slots, wh, ww);
    }
    carry_w = ww - 2 * s;
  }
}

// --- K3 policies -----------------------------------------------------------

// Level l: LL (j = 0) from the carry, or at the coarsest level from the
// LL plane; HL/LH/HH (j = 1..3) from the level's detail planes, mod the
// subband dims.
template <typename T>
struct SubbandSrc {
  struct Idx {
    size_t g;   // offset in the subband planes
    int c;      // offset in the carry
  };
  const T* ll;            // coarsest LL (used when carry is nullptr)
  const T* d0;
  const T* d1;
  const T* d2;
  const float* carry;
  int hs, ws, y0, x0, cw;
  size_t base;
  bool interior;
  __device__ __forceinline__ Idx index(int y, int x) const {
    int gy = y0 + y;
    int gx = x0 + x;
    if (!interior) {
      gy = wrap(gy, hs);
      gx = wrap(gx, ws);
    }
    return Idx{base + static_cast<size_t>(gy) * ws + gx, y * cw + x};
  }
  __device__ __forceinline__ float load(int j, Idx i) const {
    switch (j) {
      case 0: return carry != nullptr ? carry[i.c] : to_float(ll[i.g]);
      case 1: return to_float(d0[i.g]);
      case 2: return to_float(d1[i.g]);
      default: return to_float(d2[i.g]);
    }
  }
};

// Output k of level l at plane position (i, j) = (y - s, x - s) goes to
// interleaved position (2i + (k >> 1), 2j + (k & 1)): of the carry, rounded
// through the I/O dtype, or at level 0 of the image block.
template <typename T, bool kBf16>
struct InverseSink {
  T* out;
  float* carry;           // nullptr at level 0
  int s, wh, ww;
  int h, w, y0, x0;       // level 0: the image and the block's origin
  size_t base;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    if (y < s || y >= wh - s || x < s || x >= ww - s) return;
    const int iy = 2 * (y - s);
    const int ix = 2 * (x - s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(mask & (1 << k))) continue;
      const int py = iy + (k >> 1);
      const int px = ix + (k & 1);
      if (carry != nullptr) {
        carry[py * 2 * (ww - 2 * s) + px] = round_c<kBf16>(round_io<T>(v));
      } else if (y0 + py < h && x0 + px < w) {
        from_float(out + base + static_cast<size_t>(y0 + py) * w + x0 + px,
                   v);
      }
    }
  }
};

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pyramid_inverse_kernel(const int* __restrict__ table, PyrPlanes in,
                       T* __restrict__ out, int h, int w, int bh, int bw) {
  extern __shared__ __align__(16) int smem[];
  const int levels = table[0];
  const int level_ints = table[1];
  float* slots = reinterpret_cast<float*>(smem + ((level_ints + 3) & ~3));
  float* carry = slots + static_cast<size_t>(table[2]) * table[3];
  for (int l = levels - 1; l >= 0; --l) {
    const int* lv = table + kPyrHeader + l * kLevelInts;
    const int* src = table + lv[0];
    const int r = lv[1];
    const int s = lv[2];
    const int n = kHeader + kNodeInts * src[0] + 4 * src[1];
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = src[i];
    __syncthreads();
    const int hs = h >> (l + 1);
    const int ws = w >> (l + 1);
    const int ch = bh >> (l + 1);
    const int cw = bw >> (l + 1);
    const int wh = ch + 2 * r;
    const int ww = cw + 2 * r;
    const int y0 = blockIdx.y * ch - r;
    const int x0 = blockIdx.x * cw - r;
    const bool coarsest = l + 1 == levels;
    const SubbandSrc<T> src_planes{
        static_cast<const T*>(in.p[0]),
        static_cast<const T*>(in.p[1 + 3 * l]),
        static_cast<const T*>(in.p[2 + 3 * l]),
        static_cast<const T*>(in.p[3 + 3 * l]),
        coarsest ? nullptr : carry,
        hs, ws, y0, x0, ww,
        static_cast<size_t>(blockIdx.z) * hs * ws,
        y0 >= 0 && y0 + wh <= hs && x0 >= 0 && x0 + ww <= ws};
    const InverseSink<T, kBf16> sink{
        out, l == 0 ? nullptr : carry, s, wh, ww, h, w,
        static_cast<int>(blockIdx.y) * bh, static_cast<int>(blockIdx.x) * bw,
        static_cast<size_t>(blockIdx.z) * h * w};
    walk<kBf16>(smem, src_planes, sink, slots, wh, ww);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, bool kBf16>
cudaError_t launch_forward(const int* table, const void* x,
                           const PyrPlanes& out, int batch, int h, int w,
                           int bh, int bw, int smem, cudaStream_t stream) {
  auto kernel = pyramid_forward_kernel<T, kBf16>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      table, static_cast<const T*>(x), out, h, w, bh, bw);
  return cudaGetLastError();
}

template <typename T, bool kBf16>
cudaError_t launch_inverse(const int* table, const PyrPlanes& in, void* out,
                           int batch, int h, int w, int bh, int bw, int smem,
                           cudaStream_t stream) {
  auto kernel = pyramid_inverse_kernel<T, kBf16>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh, batch);
  kernel<<<grid, kThreads, smem, stream>>>(table, in, static_cast<T*>(out),
                                           h, w, bh, bw);
  return cudaGetLastError();
}

bool to_planes(void* const* ptrs, int n, PyrPlanes* planes) {
  if (n < 1 || n > 1 + 3 * kMaxLevels) return false;
  for (int k = 0; k < n; ++k) planes->p[k] = ptrs[k];
  for (int k = n; k < 1 + 3 * kMaxLevels; ++k) planes->p[k] = nullptr;
  return true;
}

}  // namespace

extern "C" {

// subbands: 1 + 3L pointers in pyramid_out_levels order (coarsest LL,
// then HL, LH, HH of each level, finest first); io_dtype: 0 float32,
// 1 float16, 2 bfloat16; smem: the launch's dynamic shared memory in
// bytes (pyramid_window.PyramidWindow.smem_bytes); device: the CUDA
// ordinal the stream belongs to.  Each returns a cudaError_t.
int pyramid_forward_launch(const int* table, const void* x,
                           void* const* subbands, int n_subbands, int batch,
                           int h, int w, int bh, int bw, int smem,
                           int io_dtype, int bf16_compute, int device,
                           void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  PyrPlanes out;
  if (!to_planes(subbands, n_subbands, &out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define PYRAMID_FORWARD_LAUNCH(T)                                          \
  return static_cast<int>(                                                 \
      bf ? launch_forward<T, true>(table, x, out, batch, h, w, bh, bw,     \
                                   smem, s)                                \
         : launch_forward<T, false>(table, x, out, batch, h, w, bh, bw,    \
                                    smem, s))
  switch (io_dtype) {
    case 0: PYRAMID_FORWARD_LAUNCH(float);
    case 1: PYRAMID_FORWARD_LAUNCH(__half);
    case 2: PYRAMID_FORWARD_LAUNCH(__nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PYRAMID_FORWARD_LAUNCH
}

int pyramid_inverse_launch(const int* table, void* const* subbands,
                           int n_subbands, void* out, int batch, int h,
                           int w, int bh, int bw, int smem, int io_dtype,
                           int bf16_compute, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  PyrPlanes in;
  if (!to_planes(subbands, n_subbands, &in)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define PYRAMID_INVERSE_LAUNCH(T)                                          \
  return static_cast<int>(                                                 \
      bf ? launch_inverse<T, true>(table, in, out, batch, h, w, bh, bw,    \
                                   smem, s)                                \
         : launch_inverse<T, false>(table, in, out, batch, h, w, bh, bw,   \
                                    smem, s))
  switch (io_dtype) {
    case 0: PYRAMID_INVERSE_LAUNCH(float);
    case 1: PYRAMID_INVERSE_LAUNCH(__half);
    case 2: PYRAMID_INVERSE_LAUNCH(__nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PYRAMID_INVERSE_LAUNCH
}

const char* pyramid_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
