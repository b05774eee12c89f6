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
// Both are one cooperative launch of persistent blocks that run the
// levels in turn, each level the window kernel's work at the block the
// per-level path picks for it: the blocks loop over the level's
// bh_l x bw_l plane tiles, each window carrying only program l's own
// halo, gathered mod the level's dims and staged through cp.async.  All
// blocks meet at a grid-wide barrier before the next level reads what
// this one wrote.  So the work is that of the per-level path, without its
// split and merge copies and launch gaps; the LL between levels goes
// through a scratch plane in device memory (mostly the 50 MB L2), stored
// in the I/O dtype, the per-level path's rounding between levels.
//
// K2, finest level to coarsest.  Level l reads the four polyphase planes
// of its image (the input at level 0, the LL level l-1 wrote at l > 0)
// with the split at stride 2 folded into the addresses; HL/LH/HH go to
// the outputs, LL to the scratch plane or, at the last level, to the LL
// output.
//
// K3, coarsest level to finest.  Level l reads the LL (the coarsest LL
// input at l = L-1, else the scratch plane level l+1 wrote) and the
// level's HL, LH, HH; its sink interleaves the four outputs (y_k at plane
// position (i, j) to pixel (2i + (k >> 1), 2j + (k & 1))) into level l's
// image: the scratch LL of level l-1 or, at level 0, the output.
//
// Pyramid table (int32, built by pyramid_window.encode_forward /
// encode_inverse):
//   header  levels, the largest level table's ints, 0 x 6
//   level   offset of its table, bh, bw, 0
//   tables  one window table per level (window_common.cuh), at offset
// Shared memory is the window kernel's for the level being walked (the
// launch reserves the largest).
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

// Copy level l's table into shared memory; returns its level ints.  The
// walk of the level before ended on a barrier.
__device__ __forceinline__ const int* load_level(const int* table, int l,
                                                 int* smem) {
  const int* lv = table + kPyrHeader + l * kLevelInts;
  const int* src = table + lv[0];
  const int n = table_len(src);
  for (int i = threadIdx.x; i < n; i += kThreads) smem[i] = src[i];
  __syncthreads();
  return lv;
}

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
struct SplitTiles {
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
pyramid_forward_kernel(const int* __restrict__ table, void* __restrict__ x,
                       PyrPlanes out, LevelPlanes scratch, int batch, int h,
                       int w) {
  extern __shared__ __align__(16) int smem[];
  cg::grid_group grid = cg::this_grid();
  const int levels = table[0];
  for (int l = 0; l < levels; ++l) {
    const int* lv = load_level(table, l, smem);
    const T* img = static_cast<const T*>(l == 0 ? x : scratch.p[l - 1]);
    const bool last = l + 1 == levels;
    const OutPlanes o{{last ? out.p[0] : scratch.p[l], out.p[1 + 3 * l],
                       out.p[2 + 3 * l], out.p[3 + 3 * l]}};
    const TileGrid tiles(batch, h >> (l + 1), w >> (l + 1), lv[1], lv[2],
                         smem[5]);
    run_tiles<T, kE, kBf16>(smem, SplitTiles<T>{img, h >> l, w >> l, o,
                                                 tiles, tiles.n_tiles});
    // level l + 1 reads the LL every block of level l wrote
    if (!last) grid.sync();
  }
}

// --- K3 ----------------------------------------------------------------

// The level's four input planes (LL, HL, LH, HH), gathered mod the plane
// dims at the edges.
template <typename T>
struct SubbandGather {
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

// Output k at plane position (gy, gx) of the tile core goes to pixel
// (2 gy + (k >> 1), 2 gx + (k & 1)) of the level's 2hp x 2wp image, in the
// I/O dtype; the ragged edge is masked, as store_core masks it.
template <typename T>
struct InterleaveSink {
  T* img;
  Geom g;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    if (y < g.r || y >= g.r + g.bh || x < g.r || x >= g.r + g.bw) return;
    const int gy = g.y0 + y - g.r;
    const int gx = g.x0 + x - g.r;
    if (gy >= g.hp || gx >= g.wp) return;
    const size_t w = 2 * static_cast<size_t>(g.wp);
    T* p = img + g.base * 4 + 2 * static_cast<size_t>(gy) * w + 2 * gx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (mask & (1 << k)) from_float(p + (k >> 1) * w + (k & 1), v);
    }
  }
};

template <typename T>
struct SubbandTiles {
  InPlanes in;
  T* img;
  TileGrid grid;
  int n_tiles;
  __device__ __forceinline__ SubbandGather<T> gather(int t) const {
    return SubbandGather<T>{in, grid.geom(t)};
  }
  __device__ __forceinline__ InterleaveSink<T> sink(int t) const {
    return InterleaveSink<T>{img, grid.geom(t)};
  }
};

template <typename T, int kE, bool kBf16>
__global__ void __launch_bounds__(kThreads)
pyramid_inverse_kernel(const int* __restrict__ table, void* __restrict__ x,
                       PyrPlanes in, LevelPlanes scratch, int batch, int h,
                       int w) {
  extern __shared__ __align__(16) int smem[];
  cg::grid_group grid = cg::this_grid();
  const int levels = table[0];
  for (int l = levels - 1; l >= 0; --l) {
    const int* lv = load_level(table, l, smem);
    const InPlanes src{{l + 1 == levels ? in.p[0] : scratch.p[l],
                        in.p[1 + 3 * l], in.p[2 + 3 * l], in.p[3 + 3 * l]}};
    T* img = static_cast<T*>(l == 0 ? x : scratch.p[l - 1]);
    const TileGrid tiles(batch, h >> (l + 1), w >> (l + 1), lv[1], lv[2],
                         smem[5]);
    run_tiles<T, kE, kBf16>(smem,
                            SubbandTiles<T>{src, img, tiles, tiles.n_tiles});
    // level l - 1 reads the image every block of level l wrote
    if (l > 0) grid.sync();
  }
}

// --- launch ------------------------------------------------------------

using PyramidKernel = void (*)(const int*, void*, PyrPlanes, LevelPlanes,
                               int, int, int);

// One launch of either kernel: ``image`` is K2's input or K3's output,
// ``subbands`` the other side.
struct Launch {
  const int* table;
  void* image;
  PyrPlanes subbands;
  LevelPlanes scratch;
  int batch, h, w, max_tiles, smem, device;
  cudaStream_t stream;
  int* info;
};

// Every block must be resident at once for the grid-wide barrier: the
// grid is the most tiles of any level, capped at what fits the card.  A
// launch that cannot be cooperative (no support, or a block that does not
// fit an SM) returns cudaErrorCooperativeLaunchTooLarge and runs nothing.
cudaError_t launch_cooperative(PyramidKernel kernel, Launch a) {
  int optin = 0;
  int coop = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, a.device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, a.device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               a.device);
  if (err != cudaSuccess) return err;
  if (!coop || a.smem > optin) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, a.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = a.max_tiles < per_sm * sms ? a.max_tiles : per_sm * sms;
  if (a.info != nullptr) {
    a.info[0] = grid;
    a.info[1] = per_sm;
  }
  void* args[] = {&a.table, &a.image, &a.subbands, &a.scratch, &a.batch,
                  &a.h, &a.w};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(grid), dim3(kThreads), args,
                                     a.smem, a.stream);
}

template <bool kInverse, typename T, int kE, bool kBf16>
cudaError_t launch_kernel(const Launch& a) {
  return launch_cooperative(kInverse ? &pyramid_inverse_kernel<T, kE, kBf16>
                                     : &pyramid_forward_kernel<T, kE, kBf16>,
                            a);
}

// elems: the walk's positions per thread (the level tables' headers')
template <bool kInverse, typename T, bool kBf16>
cudaError_t launch_elems(int elems, const Launch& a) {
  switch (elems) {
    case 4: return launch_kernel<kInverse, T, 4, kBf16>(a);
    case 6: return launch_kernel<kInverse, T, 6, kBf16>(a);
    case 9: return launch_kernel<kInverse, T, 9, kBf16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kInverse, typename T>
cudaError_t launch_compute(int bf16_compute, int elems, const Launch& a) {
  return bf16_compute ? launch_elems<kInverse, T, true>(elems, a)
                      : launch_elems<kInverse, T, false>(elems, a);
}

template <int N, typename P>
bool to_planes(void* const* ptrs, int n, P* planes) {
  if (n < 0 || n > N) return false;
  for (int k = 0; k < n; ++k) planes->p[k] = ptrs[k];
  for (int k = n; k < N; ++k) planes->p[k] = nullptr;
  return true;
}

template <bool kInverse>
int launch_pyramid(const int* table, void* image, void* const* subbands,
                   int n_subbands, void* const* scratch_planes,
                   int n_scratch, int batch, int h, int w, int max_tiles,
                   int smem, int elems, int io_dtype, int bf16_compute,
                   int device, void* stream, int* info) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  Launch a{table, image, {}, {}, batch, h, w, max_tiles, smem, device,
           static_cast<cudaStream_t>(stream), info};
  if (n_subbands < 1 || max_tiles < 1 ||
      !to_planes<1 + 3 * kMaxLevels>(subbands, n_subbands, &a.subbands) ||
      !to_planes<kMaxLevels>(scratch_planes, n_scratch, &a.scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (io_dtype) {
    case 0:
      return launch_compute<kInverse, float>(bf16_compute, elems, a);
    case 1:
      return launch_compute<kInverse, __half>(bf16_compute, elems, a);
    case 2:
      return launch_compute<kInverse, __nv_bfloat16>(bf16_compute, elems, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// image: K2's (B, H, W) input or K3's output; subbands: 1 + 3L pointers
// in pyramid_out_levels order (coarsest LL, then HL, LH, HH of each
// level, finest first), K2's outputs or K3's inputs; scratch: L - 1 LL
// planes of levels 0 .. L-2 in the I/O dtype; max_tiles: the most tiles
// of any level; io_dtype: 0 float32, 1 float16, 2 bfloat16; smem: the
// launch's dynamic shared memory in bytes (pyramid_window.PyramidWindow.
// smem_bytes); elems: the walk's positions per thread (pyramid_window.
// PyramidWindow.elems); device: the CUDA ordinal the stream belongs to;
// info: receives the grid and the resident blocks per SM (may be null).
// Each returns a cudaError_t.
int pyramid_forward_launch(const int* table, void* image,
                           void* const* subbands, int n_subbands,
                           void* const* scratch_planes, int n_scratch,
                           int batch, int h, int w, int max_tiles, int smem,
                           int elems, int io_dtype, int bf16_compute,
                           int device, void* stream, int* info) {
  return launch_pyramid<false>(table, image, subbands, n_subbands,
                               scratch_planes, n_scratch, batch, h, w,
                               max_tiles, smem, elems, io_dtype,
                               bf16_compute, device, stream, info);
}

int pyramid_inverse_launch(const int* table, void* image,
                           void* const* subbands, int n_subbands,
                           void* const* scratch_planes, int n_scratch,
                           int batch, int h, int w, int max_tiles, int smem,
                           int elems, int io_dtype, int bf16_compute,
                           int device, void* stream, int* info) {
  return launch_pyramid<true>(table, image, subbands, n_subbands,
                              scratch_planes, n_scratch, batch, h, w,
                              max_tiles, smem, elems, io_dtype, bf16_compute,
                              device, stream, info);
}

const char* pyramid_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
