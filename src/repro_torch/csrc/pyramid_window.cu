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
// in float32), the table walk in practice.
//
// K2, one cooperative launch, finest level to coarsest.  Level l is the
// window kernel's work on the four polyphase planes of that level's image
// (the input at level 0, the LL level l-1 wrote at l > 0): persistent
// blocks loop over the level's bh_l x bw_l plane tiles, each window
// carrying only program l's own halo, gathered with the split at stride 2
// folded into the addresses (mod H_l / W_l at the edges) and staged
// through cp.async; HL/LH/HH go to the outputs, LL to a scratch plane in
// the I/O dtype (the per-level path's rounding between levels) or, at
// the last level, to the LL output.  All blocks then meet at a grid-wide
// barrier before the next level reads the LL.  So the work is that of
// the per-level path, without its split copies and launch gaps; the LL
// between levels goes through device memory (mostly the 50 MB L2).
//
// K3, finest-first grid of image-space blocks bh x bw (multiples of 2^L),
// coarsest level to finest, every intermediate LL kept in shared memory:
// level l gathers the LL window (the carry, or at the coarsest level the
// LL plane) and the level's three detail windows with halo margins[l+1],
// mod each subband's dims; runs program l with its outputs at margin
// shrinks[l]; and interleaves the four outputs (out[2i,2j] = y0,
// [2i,2j+1] = y1, [2i+1,2j] = y2, [2i+1,2j+1] = y3) into the carry,
// rounded through the I/O dtype, or at level 0 into the block of the
// image, ragged edge masked.  Its windows carry the compound margin of
// the coarser levels.
//
// Pyramid table (int32, built by pyramid_window.encode_forward /
// encode_inverse):
//   header  levels, level_ints, n_slots, slot_floats, front, back, 0, 0
//           (the largest level table, slot count, window, pads)
//   level   offset of its table, then K2: bh, bw, 0; K3: halo, shrink, 0
//   tables  one window table per level (window_common.cuh), at offset
// K2's shared memory is the window kernel's for the level being walked;
// K3's: the largest level table (level_ints, rounded up to 4), the front
// pad, room for one input stage of four windows and n_slots slots of
// slot_floats each (level l's stage and slots at its own window size), the
// back pad, then the carry.
#include <cooperative_groups.h>

#include "window_common.cuh"

namespace {

using namespace window;
namespace cg = cooperative_groups;

constexpr int kMaxLevels = 8;
constexpr int kPyrHeader = 8;
constexpr int kLevelInts = 4;

struct PyrPlanes { void* p[1 + 3 * kMaxLevels]; };
struct LevelPlanes { void* p[kMaxLevels]; };

// --- K2 ----------------------------------------------------------------

// Plane j of level l's image: window sample (y, x) of the tile is image
// pixel (2 (y0 - r + y) + dy, 2 (x0 - r + x) + dx) with (dy, dx) =
// (j >> 1, j & 1); H_l and W_l are even, so the wrap of the even pixel
// keeps the phase and the odd one never needs its own.
template <typename T>
struct SplitGather {
  using Idx = size_t;
  const T* img;
  int h, w;       // the level's image
  Geom g;         // plane-space tile
  __device__ __forceinline__ Idx index(int y, int x) const {
    int gy = 2 * (g.y0 - g.r + y);
    int gx = 2 * (g.x0 - g.r + x);
    if (!g.interior) {
      gy = wrap(gy, h);
      gx = wrap(gx, w);
    }
    return g.base * 4 + static_cast<size_t>(gy) * w + gx;
  }
  __device__ __forceinline__ const T* ptr(int j, Idx i) const {
    return img + i + static_cast<size_t>(j >> 1) * w + (j & 1);
  }
};

template <typename T>
struct LevelTiles {
  const T* img;
  int h, w;
  OutPlanes out;  // LL (scratch or the LL output), HL, LH, HH
  TileGrid grid;
  int n_tiles;
  __device__ __forceinline__ SplitGather<T> gather(int t) const {
    return SplitGather<T>{img, h, w, grid.geom(t)};
  }
  __device__ __forceinline__ CoreSink<T> sink(int t) const {
    return CoreSink<T>{out, grid.geom(t)};
  }
};

template <typename T, int kE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pyramid_forward_kernel(const int* __restrict__ table,
                       const T* __restrict__ x, PyrPlanes out,
                       LevelPlanes scratch, int batch, int h, int w) {
  extern __shared__ __align__(16) int smem[];
  cg::grid_group grid = cg::this_grid();
  const int levels = table[0];
  for (int l = 0; l < levels; ++l) {
    const int* lv = table + kPyrHeader + l * kLevelInts;
    const int* src = table + lv[0];
    const int n = table_len(src);
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = src[i];
    __syncthreads();
    const T* img = l == 0 ? x : static_cast<const T*>(scratch.p[l - 1]);
    const bool last = l + 1 == levels;
    const OutPlanes o{{last ? out.p[0] : scratch.p[l], out.p[1 + 3 * l],
                       out.p[2 + 3 * l], out.p[3 + 3 * l]}};
    const TileGrid tiles(batch, h >> (l + 1), w >> (l + 1), lv[1], lv[2],
                         src[5]);
    run_tiles<T, kE, kBf16>(smem, LevelTiles<T>{img, h >> l, w >> l, o,
                                                 tiles, tiles.n_tiles});
    // level l + 1 reads the LL every block of level l wrote
    if (!last) grid.sync();
  }
}

// --- K3 ----------------------------------------------------------------

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

template <typename T, int kE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pyramid_inverse_kernel(const int* __restrict__ table, PyrPlanes in,
                       T* __restrict__ out, int h, int w, int bh, int bw) {
  extern __shared__ __align__(16) int smem[];
  const int levels = table[0];
  const int slot = table[3];
  float* in0 = stage0(smem, table[1], table[4]);
  float* carry = in0 + (4 + table[2]) * slot + table[5];
  for (int l = levels - 1; l >= 0; --l) {
    const int* lv = table + kPyrHeader + l * kLevelInts;
    const int* src = table + lv[0];
    const int r = lv[1];
    const int s = lv[2];
    const int n = table_len(src);
    // the walk of the level before ended on a barrier
    for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = src[i];
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
    load_window(src_planes, in0, wh, ww);
    __syncthreads();
    const InverseSink<T, kBf16> sink{
        out, l == 0 ? nullptr : carry, s, wh, ww, h, w,
        static_cast<int>(blockIdx.y) * bh, static_cast<int>(blockIdx.x) * bw,
        static_cast<size_t>(blockIdx.z) * h * w};
    // the level's slots follow its input stage (the table's offsets)
    walk<kE, kBf16>(smem, in0, sink);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int kE, bool kBf16>
cudaError_t launch_forward(const int* table, const void* x,
                           const PyrPlanes& out, const LevelPlanes& scratch,
                           int batch, int h, int w, int max_tiles, int smem,
                           int device, cudaStream_t stream,
                           int* info) {
  auto kernel = pyramid_forward_kernel<T, kE, kBf16>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  int sms = 0;
  int coop = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || !coop) return cudaErrorCooperativeLaunchTooLarge;
  // every block must be resident at once for the grid-wide barrier
  const int grid = max_tiles < per_sm * sms ? max_tiles : per_sm * sms;
  if (info != nullptr) {
    info[0] = grid;
    info[1] = per_sm;
  }
  const T* xt = static_cast<const T*>(x);
  void* args[] = {const_cast<int**>(&table), const_cast<T**>(&xt),
                  const_cast<PyrPlanes*>(&out),
                  const_cast<LevelPlanes*>(&scratch), &batch, &h, &w};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(grid), dim3(kThreads), args, smem,
                                     stream);
}

template <typename T, int kE, bool kBf16>
cudaError_t launch_inverse(const int* table, const PyrPlanes& in, void* out,
                           int batch, int h, int w, int bh, int bw, int smem,
                           cudaStream_t stream, int* info) {
  auto kernel = pyramid_inverse_kernel<T, kE, kBf16>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + bw - 1) / bw, (h + bh - 1) / bh, batch);
  if (info != nullptr) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    info[0] = static_cast<int>(grid.x * grid.y * grid.z);
  }
  kernel<<<grid, kThreads, smem, stream>>>(table, in, static_cast<T*>(out),
                                           h, w, bh, bw);
  return cudaGetLastError();
}

// The walk's positions per thread (the level tables' headers').
#define PYRAMID_ELEMS(CALL)                                                \
  switch (elems) {                                                         \
    case 4: return CALL(4);                                                \
    case 6: return CALL(6);                                                \
    case 9: return CALL(9);                                                \
    default: return cudaErrorInvalidValue;                                 \
  }

template <typename T, bool kBf16>
cudaError_t forward_elems(int elems, const int* table, const void* x,
                          const PyrPlanes& out, const LevelPlanes& scratch,
                          int batch, int h, int w, int max_tiles, int smem,
                          int device, cudaStream_t stream, int* info) {
#define PYRAMID_FORWARD(E)                                                 \
  launch_forward<T, E, kBf16>(table, x, out, scratch, batch, h, w,         \
                              max_tiles, smem, device, stream, info)
  PYRAMID_ELEMS(PYRAMID_FORWARD)
#undef PYRAMID_FORWARD
}

template <typename T, bool kBf16>
cudaError_t inverse_elems(int elems, const int* table, const PyrPlanes& in,
                          void* out, int batch, int h, int w, int bh, int bw,
                          int smem, cudaStream_t stream, int* info) {
#define PYRAMID_INVERSE(E)                                                 \
  launch_inverse<T, E, kBf16>(table, in, out, batch, h, w, bh, bw, smem,   \
                              stream, info)
  PYRAMID_ELEMS(PYRAMID_INVERSE)
#undef PYRAMID_INVERSE
}

#undef PYRAMID_ELEMS

template <int N, typename P>
bool to_planes(void* const* ptrs, int n, P* planes) {
  if (n < 0 || n > N) return false;
  for (int k = 0; k < n; ++k) planes->p[k] = ptrs[k];
  for (int k = n; k < N; ++k) planes->p[k] = nullptr;
  return true;
}

}  // namespace

extern "C" {

// subbands: 1 + 3L pointers in pyramid_out_levels order (coarsest LL,
// then HL, LH, HH of each level, finest first); scratch: L - 1 LL planes
// of levels 0 .. L-2 in the I/O dtype; max_tiles: the most tiles of any
// level; io_dtype: 0 float32, 1 float16, 2 bfloat16; smem: the launch's
// dynamic shared memory in bytes (pyramid_window.PyramidWindow.smem_bytes);
// elems: the walk's positions per thread (pyramid_window.PyramidWindow.
// elems); device: the CUDA ordinal the stream belongs to; info: receives
// the grid and the resident blocks per SM (may be null).  Each returns a
// cudaError_t.
int pyramid_forward_launch(const int* table, const void* x,
                           void* const* subbands, int n_subbands,
                           void* const* scratch_planes, int n_scratch,
                           int batch, int h, int w, int max_tiles, int smem,
                           int elems, int io_dtype, int bf16_compute,
                           int device, void* stream, int* info) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  PyrPlanes out;
  LevelPlanes scratch;
  if (n_subbands < 1 ||
      !to_planes<1 + 3 * kMaxLevels>(subbands, n_subbands, &out) ||
      !to_planes<kMaxLevels>(scratch_planes, n_scratch, &scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define PYRAMID_FORWARD_LAUNCH(T)                                          \
  return static_cast<int>(                                                 \
      bf ? forward_elems<T, true>(elems, table, x, out, scratch, batch, h, \
                                  w, max_tiles, smem, device, s, info)     \
         : forward_elems<T, false>(elems, table, x, out, scratch, batch,   \
                                   h, w, max_tiles, smem, device, s, info))
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
                           int w, int bh, int bw, int smem, int elems,
                           int io_dtype,
                           int bf16_compute, int device, void* stream,
                           int* info) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  PyrPlanes in;
  if (n_subbands < 1 ||
      !to_planes<1 + 3 * kMaxLevels>(subbands, n_subbands, &in)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define PYRAMID_INVERSE_LAUNCH(T)                                          \
  return static_cast<int>(                                                 \
      bf ? inverse_elems<T, true>(elems, table, in, out, batch, h, w, bh,  \
                                  bw, smem, s, info)                       \
         : inverse_elems<T, false>(elems, table, in, out, batch, h, w, bh, \
                                   bw, smem, s, info))
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
