// Reversible lifting kernel (RL): one whole level of the 2-D reversible
// integer wavelet of ISO/IEC 15444-1 Annex F (JPEG 2000 lossless, the
// 5-3 with floors), forward or inverse, in one launch, on int32 samples.
//
// Replaces no TPU kernel: the reference package has no integer path.  On
// an H100 a level is bound by device-memory bytes: it reads every sample
// once and writes it once, with a few integer adds and shifts each.  What
// the design does about that:
//
// * a block owns a tile of kTileP x kTileQ output pairs (each pair four
//   subband samples) of one image and stages the tile's window, the
//   interleaved samples with the 5-3's halo (2 before, 1 after, on each
//   axis), in shared memory through cp.async: one read of the level's
//   input, every load of a thread in flight at once, rows of the window
//   contiguous in device memory;
// * both 1-D passes run there, in Annex F's order: the forward (2D_SD)
//   lifts every column of the window (predict, then update), then every
//   row of the tile (predict, then update), and writes the four subbands
//   as planar tensors; the inverse (2D_SR) stages the four subbands
//   interleaved, undoes the rows (update, then predict), then the
//   columns, and writes the interleaved level.  No split or merge copy
//   is made on either side;
// * the edges are Annex F's whole-sample symmetric extension, in the
//   index: a window position past an edge loads the sample mirrored into
//   the image (period 2 (N - 1)), which is the extension of every
//   intermediate signal too, as each pass acts on whole rows or columns;
// * the vertical steps map consecutive threads to consecutive columns,
//   the horizontal steps to consecutive rows of the odd-strided window,
//   so neither has a shared-memory bank conflict.
//
// Arithmetic is exact: int32 adds and arithmetic shifts (the floor of a
// division by a power of two), the same steps as the plain version
// (repro_torch/core/reversible.py), so the two agree bit for bit.
#include "window_common.cuh"

namespace {

using window::wrap;

constexpr int kThreads = 256;
// A tile is kP x kQ output pairs; its window holds the tile's 2 kP x 2 kQ
// samples with 2 before and 1 after on each axis (the forward), or 1
// before and 2 after (the inverse): an odd row stride.  A level runs at
// 32 x 64 pairs, or at 32 x 32 or 16 x 16 where its planes are narrower
// (rev_lift_launch), so that a small level does not walk a window mostly
// past its edge.  At (1871, 512, 512) int32 on an H100, 32 x 64 took 1.50 /
// 1.91 ms a level-0 forward / inverse, 32 x 32 1.71 / 2.08, 16 x 64 1.70
// / 2.15; 512 threads, or a register cap for 6 or 8 resident blocks, lost.
template <int kP, int kQ>
struct Tile {
  static constexpr int kTileP = kP;
  static constexpr int kTileQ = kQ;
  static constexpr int kRows = 2 * kP + 3;
  static constexpr int kCols = 2 * kQ + 3;
};

struct Steps {
  int ps;  // d -= (s[n] + s[n+1]) >> ps
  int us;  // s += (d[n-1] + d[n] + ur) >> us
  int ur;
};

// Whole-sample symmetric extension of index i of a signal of n >= 2.
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * (n - 1);
  const int m = wrap(i, p);
  return m < n ? m : p - m;
}

// The four subbands of a level, planar (B, h/2, w/2) each.
struct Bands {
  int* ll;
  int* hl;  // high horizontally
  int* lh;
  int* hh;
};

// One lifting step of one axis of a window kCols wide: at positions kFirst,
// kFirst + 2, ... (kN of them) of the axis, along kLines lines from line
// kL0 (columns when kVert, else rows), the predict (kUpdate false: v -=
// (a + b) >> ps, the neighbours a and b on the axis) or the update (v +=
// (a + b + ur) >> us); kInverse undoes it.  Consecutive threads take
// consecutive lines, so each access is one conflict-free wavefront.
template <int kCols, bool kVert, bool kUpdate, bool kInverse, int kFirst,
          int kN, int kL0, int kLines>
__device__ __forceinline__ void step(int* w, const Steps& st) {
  constexpr int kStride = kVert ? kCols : 1;
  for (int i = threadIdx.x; i < kN * kLines; i += kThreads) {
    const int j = i / kLines, line = kL0 + i - j * kLines;
    const int pos = kFirst + 2 * j;
    int* v = kVert ? w + pos * kCols + line : w + line * kCols + pos;
    const int t = kUpdate ? (v[-kStride] + v[kStride] + st.ur) >> st.us
                          : (v[-kStride] + v[kStride]) >> st.ps;
    *v = (kUpdate != kInverse) ? *v + t : *v - t;
  }
}

template <typename Tl>
__global__ void __launch_bounds__(kThreads)
rev_lift_forward(const int* __restrict__ x, Bands out, int batch, int h,
                 int w, Steps st) {
  constexpr int kTileP = Tl::kTileP, kTileQ = Tl::kTileQ;
  constexpr int kRows = Tl::kRows, kCols = Tl::kCols;
  __shared__ int win[kRows * kCols];
  __shared__ int rows[kRows];  // image row of each window row
  __shared__ int cols[kCols];
  const int hp = h >> 1, wp = w >> 1;
  const int p0 = blockIdx.y * kTileP, q0 = blockIdx.x * kTileQ;
  const int tp = min(kTileP, hp - p0), tq = min(kTileQ, wp - q0);
  // window position r is image row 2 p0 - 2 + r, mirrored
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    rows[i] = mirror(2 * p0 - 2 + i, h);
  }
  for (int i = threadIdx.x; i < kCols; i += kThreads) {
    cols[i] = mirror(2 * q0 - 2 + i, w);
  }
  __syncthreads();
  const long long image = static_cast<long long>(h) * w;
  const long long band = static_cast<long long>(hp) * wp;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const int* src = x + b * image;
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i - r * kCols;
      __pipeline_memcpy_async(win + i,
                              src + static_cast<long long>(rows[r]) * w +
                                  cols[c],
                              sizeof(int));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // columns: d at window rows 1, 3, ..., 2 kTileP + 1 (pairs p0 - 1 to
    // p0 + kTileP - 1), then s at rows 2, 4, ..., 2 kTileP
    step<kCols, true, false, false, 1, kTileP + 1, 0, kCols>(win, st);
    __syncthreads();
    step<kCols, true, true, false, 2, kTileP, 0, kCols>(win, st);
    __syncthreads();
    // rows of the tile (window rows 2 to 2 kTileP + 1), likewise
    step<kCols, false, false, false, 1, kTileQ + 1, 2, 2 * kTileP>(win, st);
    __syncthreads();
    step<kCols, false, true, false, 2, kTileQ, 2, 2 * kTileP>(win, st);
    __syncthreads();
    const long long o = b * band + static_cast<long long>(p0) * wp + q0;
    for (int i = threadIdx.x; i < tp * kTileQ; i += kThreads) {
      const int y = i / kTileQ, k = i - y * kTileQ;
      if (k >= tq) continue;
      const int* v = win + (2 * y + 2) * kCols + 2 * k + 2;
      const long long dst = o + static_cast<long long>(y) * wp + k;
      out.ll[dst] = v[0];
      out.hl[dst] = v[1];
      out.lh[dst] = v[kCols];
      out.hh[dst] = v[kCols + 1];
    }
    __syncthreads();  // the window is reloaded for the next image
  }
}

template <typename Tl>
__global__ void __launch_bounds__(kThreads)
rev_lift_inverse(Bands in, int* __restrict__ x, int batch, int h, int w,
                 Steps st) {
  constexpr int kTileP = Tl::kTileP, kTileQ = Tl::kTileQ;
  constexpr int kRows = Tl::kRows, kCols = Tl::kCols;
  __shared__ int win[kRows * kCols];
  __shared__ int rows[kRows];  // interleaved row of each window row
  __shared__ int cols[kCols];
  const int hp = h >> 1, wp = w >> 1;
  const int p0 = blockIdx.y * kTileP, q0 = blockIdx.x * kTileQ;
  const int tp = min(kTileP, hp - p0), tq = min(kTileQ, wp - q0);
  // window position r is interleaved row 2 p0 - 1 + r, mirrored: an even
  // one is a row of LL and HL, an odd one of LH and HH
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    rows[i] = mirror(2 * p0 - 1 + i, h);
  }
  for (int i = threadIdx.x; i < kCols; i += kThreads) {
    cols[i] = mirror(2 * q0 - 1 + i, w);
  }
  __syncthreads();
  const long long image = static_cast<long long>(h) * w;
  const long long band = static_cast<long long>(hp) * wp;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i - r * kCols;
      const int gy = rows[r], gx = cols[c];
      const int* src = (gy & 1) ? ((gx & 1) ? in.hh : in.lh)
                                : ((gx & 1) ? in.hl : in.ll);
      __pipeline_memcpy_async(
          win + i,
          src + b * band + static_cast<long long>(gy >> 1) * wp + (gx >> 1),
          sizeof(int));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // rows, every one of the window: restore the even columns 1, 3, ...,
    // 2 kTileQ + 1 (image columns 2 q0 to 2 q0 + 2 kTileQ), then the odd
    // ones 2, 4, ..., 2 kTileQ
    step<kCols, false, true, true, 1, kTileQ + 1, 0, kRows>(win, st);
    __syncthreads();
    step<kCols, false, false, true, 2, kTileQ, 0, kRows>(win, st);
    __syncthreads();
    // columns 1 to 2 kTileQ (the tile's), likewise along the rows
    step<kCols, true, true, true, 1, kTileP + 1, 1, 2 * kTileQ>(win, st);
    __syncthreads();
    step<kCols, true, false, true, 2, kTileP, 1, 2 * kTileQ>(win, st);
    __syncthreads();
    int* dst = x + b * image + static_cast<long long>(2 * p0) * w + 2 * q0;
    for (int i = threadIdx.x; i < 2 * tp * 2 * kTileQ; i += kThreads) {
      const int r = i / (2 * kTileQ), c = i - r * (2 * kTileQ);
      if (c >= 2 * tq) continue;
      dst[static_cast<long long>(r) * w + c] = win[(r + 1) * kCols + c + 1];
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, const dim3& grid, int* info) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (info != nullptr) {
    const long long blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
    info[0] = static_cast<int>(blocks < 2147483647LL ? blocks : 2147483647LL);
    info[1] = per_sm;
  }
  return cudaSuccess;
}

template <typename Tl>
cudaError_t launch(int inverse, void* x, const Bands& bands, int batch,
                   int h, int w, const Steps& st, cudaStream_t s,
                   int* info) {
  const int hp = h >> 1, wp = w >> 1;
  const dim3 grid(static_cast<unsigned>((wp + Tl::kTileQ - 1) / Tl::kTileQ),
                  static_cast<unsigned>((hp + Tl::kTileP - 1) / Tl::kTileP),
                  static_cast<unsigned>(batch < 65535 ? batch : 65535));
  cudaError_t err;
  if (inverse) {
    err = occupancy(rev_lift_inverse<Tl>, grid, info);
    if (err != cudaSuccess) return err;
    rev_lift_inverse<Tl><<<grid, kThreads, 0, s>>>(
        bands, static_cast<int*>(x), batch, h, w, st);
  } else {
    err = occupancy(rev_lift_forward<Tl>, grid, info);
    if (err != cudaSuccess) return err;
    rev_lift_forward<Tl><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(x), bands, batch, h, w, st);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One level of B int32 images (B, h, w), h and w even and at least 2,
// contiguous, and its four subbands (B, h/2, w/2) each, contiguous:
// inverse 0 reads x and writes ll, hl, lh, hh; inverse 1 the other way
// round.  ps, us, ur: the lifting pair's predict shift, update shift and
// update rounding (1, 2, 2 for the 5-3).  device: the CUDA ordinal the
// stream belongs to; info: receives the grid's blocks and the resident
// blocks per SM (may be null).  Returns a cudaError_t.
int rev_lift_launch(int inverse, void* x, void* ll, void* hl, void* lh,
                    void* hh, int batch, int h, int w, int ps, int us,
                    int ur, int device, void* stream, int* info) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (batch < 1 || h < 2 || w < 2 || (h & 1) || (w & 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Steps st{ps, us, ur};
  const Bands bands{static_cast<int*>(ll), static_cast<int*>(hl),
                    static_cast<int*>(lh), static_cast<int*>(hh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hp = h >> 1, wp = w >> 1;
  cudaError_t err;
  if (hp < 32 || wp < 32) {
    err = launch<Tile<16, 16>>(inverse, x, bands, batch, h, w, st, s, info);
  } else if (wp < 64) {
    err = launch<Tile<32, 32>>(inverse, x, bands, batch, h, w, st, s, info);
  } else {
    err = launch<Tile<32, 64>>(inverse, x, bands, batch, h, w, st, s, info);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* rev_lift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
