// Device functions shared by the window kernel (tap_window.cu, K1) and the
// fused-pyramid kernels (pyramid_window.cu, K2 and K3): the wave walk of
// one encoded tap-program table over a window held in shared memory, the
// staging of input windows, and the persistent tile loop.
//
// Program table of one window (int32, built by tap_window.table_rows):
//   header  barriers per tile, waves, nodes, terms, slots, halo, wh, ww,
//           front pad, back pad, positions per thread (kE), 0 (12 ints)
//   wave    first node, nodes, lo, hi                          (4 ints)
//   node    first term, terms, slot offset (-1 = none), output mask
//   term    offset, coefficient bits                           (2 ints)
// The nodes of one dependency wave do not read each other, so the block
// evaluates them without a barrier between them, over one flat range
// [lo, hi) of window positions (pos = y * ww + x), the union of their
// regions, and puts a barrier after the wave.  A term reads the value at
// pos + offset from the input stage: offsets fold the source (plane j of
// the stage, or a slot; the slots follow the stage) and the (km, kn)
// shift.  A position off a node's region computes a value nobody reads:
// its reads stay inside the shared memory thanks to the front and back
// pads, and its stores land in the node's own slot, off the region its
// readers use, or are masked by the sink.
//
// Shared memory of one walk (floats after the table, rounded up to 16
// bytes): front pad, the input stage of four wh x ww windows (plane j at
// j * wh * ww), the slots, the back pad.
//
// Where the inputs come from and where the outputs go differs between
// the kernels, so the stage and the walk take policies:
//   Gather  typename Idx; Idx index(int y, int x) const;
//           const T* ptr(int j, Idx) const   (input plane j, device memory)
//   Sink    void operator()(int mask, int y, int x, float v) const
//           (window position (y, x) of an output node, `mask` its bits)
// The fused-pyramid kernels' policies are at the end of this file: four
// planes (PlaneGather, CoreSink), an image read as its polyphase planes
// (SplitGather) and four outputs written as one image (InterleaveSink);
// the window kernel reads and writes either layout through one strided
// policy with the same addresses (tap_window.cu).
//
// Arithmetic: every node starts at -0.0 (x + -0.0 == x for every x) and
// adds round(read * c) left to right with __fmul_rn / __fadd_rn (no FMA
// contraction).  c == 1 and c == -1 multiply exactly, so the sums equal
// the plain versions' strength-reduced ones bit for bit, with no branch
// in the term loop.  With bf16 compute every read, product and sum is
// rounded to bfloat16 (float32 holds more than 2*8+2 significand bits, so
// the emulation is exact; a read of a slot is already rounded).
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include <type_traits>

namespace window {

constexpr int kHeader = 12;
constexpr int kWaveInts = 4;
constexpr int kNodeInts = 4;
constexpr int kThreads = 256;
// Window positions each thread carries through one pass of a wave (the
// walk's template parameter kE, one of tap_window.ELEMS_CHOICES): a warp
// takes 32 * kE consecutive positions, lane l the ones at l + 32 e, so
// every shared read is one conflict-free wavefront and one term's table
// read serves all kE of them.  The encoder picks, per table, the count
// that needs the fewest position slots per thread over its waves (a pass
// costs the same however few of its positions lie in the wave), and
// writes it to the header.
// positions per thread and loop of the input stage
constexpr int kStageElems = 4;
// float inputs reach shared memory through cp.async (else through
// registers, as 16-bit inputs always do)
constexpr bool kAsyncStage = true;

struct InPlanes { const void* p[4]; };
struct OutPlanes { void* p[4]; };

// Where a tile's window sits: plane sizes, tile core, halo.
struct Geom {
  int hp, wp, bh, bw, r, y0, x0;
  size_t base;    // batch offset of the planes
  bool interior;  // window needs no wrap-around
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Round to the compute dtype (bfloat16 when kBf16, else float32).
template <bool kBf16>
__device__ __forceinline__ float round_c(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Round through the I/O dtype T and back to float.
template <typename T>
__device__ __forceinline__ float round_io(float v) {
  T t;
  from_float(&t, v);
  return to_float(t);
}

__device__ __forceinline__ int wrap(int v, int n) {
  int m = v % n;
  return m < 0 ? m + n : m;
}

// Row of flat index i in a region ``w`` wide: floor((i + 0.5) / w) in
// float.  The true quotient (i + 0.5) / w lies at least 0.5 / w from an
// integer; the two roundings (of 1 / w and of the product) move it by
// less than (i + 0.5) / w * 2^-23, which stays below 0.5 / w while
// i + 0.5 < 2^22, whatever w is.  The encoders refuse any window of more
// than tap_window.MAX_WINDOW_ELEMS (< 2^16) positions, and the CPU tests
// check this formula against integer division for every width up to
// tap_window.MAX_WINDOW_WIDTH at every index a window can hold.
__device__ __forceinline__ int row_of(int i, float inv_w) {
  return __float2int_rd((static_cast<float>(i) + 0.5f) * inv_w);
}

// Ints of one program table.
__device__ __forceinline__ int table_len(const int* t) {
  return kHeader + kWaveInts * t[1] + kNodeInts * t[2] + 2 * t[3];
}

// First input stage of a walk whose table (``table_ints`` long) sits at
// the start of shared memory, after the table and the front pad.
__device__ __forceinline__ float* stage0(int* smem, int table_ints,
                                         int front) {
  return reinterpret_cast<float*>(smem + ((table_ints + 3) & ~3)) + front;
}

// Store window position (y, x) to every output plane in ``mask`` if it
// lies in the tile core and inside the plane (the ragged edge is masked).
template <typename T>
__device__ __forceinline__ void store_core(const OutPlanes& out, int mask,
                                           const Geom& g, int y, int x,
                                           float v) {
  if (y < g.r || y >= g.r + g.bh || x < g.r || x >= g.r + g.bw) return;
  const int gy = g.y0 + y - g.r;
  const int gx = g.x0 + x - g.r;
  if (gy >= g.hp || gx >= g.wp) return;
  const size_t idx = g.base + static_cast<size_t>(gy) * g.wp + gx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (mask & (1 << k)) from_float(static_cast<T*>(out.p[k]) + idx, v);
  }
}

// Copy the four wh x ww input windows of one tile into ``buf``,
// kStageElems positions per thread at a time (mod-wrapped where the gather wraps):
// float planes 4 bytes at a time through cp.async, as one group the
// caller waits for; 16-bit planes through registers, converted.
template <typename T, typename Gather>
__device__ __forceinline__ void stage(const Gather& g, float* buf, int wh,
                                      int ww) {
  const int plane = wh * ww;
  const float inv_w = 1.0f / ww;
  for (int i0 = threadIdx.x; i0 < plane; i0 += kThreads * kStageElems) {
    typename Gather::Idx idx[kStageElems];
#pragma unroll
    for (int e = 0; e < kStageElems; ++e) {
      const int i = min(i0 + e * kThreads, plane - 1);
      const int y = row_of(i, inv_w);
      idx[e] = g.index(y, i - y * ww);
    }
    if constexpr (kAsyncStage && std::is_same<T, float>::value) {
#pragma unroll
      for (int e = 0; e < kStageElems; ++e) {
        if (i0 + e * kThreads >= plane) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          __pipeline_memcpy_async(buf + j * plane + i0 + e * kThreads,
                                  g.ptr(j, idx[e]), sizeof(float));
        }
      }
    } else {
      float v[4][kStageElems];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < kStageElems; ++e) v[j][e] = to_float(*g.ptr(j, idx[e]));
      }
#pragma unroll
      for (int e = 0; e < kStageElems; ++e) {
        if (i0 + e * kThreads >= plane) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) buf[j * plane + i0 + e * kThreads] = v[j][e];
      }
    }
  }
  __pipeline_commit();
}

// One wave over its flat range: per pass, each node of the wave over the
// thread's kE positions (its terms left to right), then its values to
// its slot and to the sink.
template <int kE, bool kBf16, typename Sink>
__device__ __forceinline__ void eval_wave(const int* wave, const int4* nodes,
                                          const int2* terms, const float* in,
                                          float* slots, int ww, float inv_ww,
                                          const Sink& sink) {
  const int n0 = wave[0];
  const int n1 = n0 + wave[1];
  const int lo = wave[2];
  const int hi = wave[3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = lo + warp * 32 * kE + lane; p < hi; p += kThreads * kE) {
    for (int n = n0; n < n1; ++n) {
      const int4 nd = nodes[n];
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = -0.0f;
      const int2* tm = terms + nd.x;
      const int2* end = tm + nd.y;
#pragma unroll 2
      for (; tm < end; ++tm) {
        const int2 t = *tm;
        const float c = __int_as_float(t.y);
        const float* s = in + p + t.x;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          acc[e] = round_c<kBf16>(__fadd_rn(
              acc[e], round_c<kBf16>(__fmul_rn(round_c<kBf16>(s[32 * e]),
                                               c))));
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int q = p + 32 * e;
        if (q >= hi) break;
        if (nd.z >= 0) slots[nd.z + q] = acc[e];
        if (nd.w) {
          const int y = row_of(q, inv_ww);
          sink(nd.w, y, q - y * ww, acc[e]);
        }
      }
    }
  }
}

// Walk one table (in shared memory) over the input stage ``in``, whose
// slots follow it: every wave in turn, a barrier after each.
template <int kE, bool kBf16, typename Sink>
__device__ __forceinline__ void walk(const int* table, float* in,
                                     const Sink& sink) {
  const int n_waves = table[1];
  const int ww = table[7];
  const float inv_ww = 1.0f / ww;
  const int* waves = table + kHeader;
  const int4* nodes =
      reinterpret_cast<const int4*>(waves + n_waves * kWaveInts);
  const int2* terms = reinterpret_cast<const int2*>(nodes + table[2]);
  float* slots = in + 4 * table[6] * ww;
  for (int w = 0; w < n_waves; ++w) {
    eval_wave<kE, kBf16>(waves + w * kWaveInts, nodes, terms, in, slots, ww,
                         inv_ww, sink);
    // barrier after the wave
    __syncthreads();
  }
}

// Persistent tile loop of one table (in shared memory at ``smem``): the
// block takes tiles blockIdx.x, + gridDim.x, ...; the next tile's inputs
// are requested as soon as the current tile's walk ends.  ``Tiles`` gives
// n_tiles, gather(t) (a Gather) and sink(t) (a Sink).  Ends after a
// barrier.
template <typename T, int kE, bool kBf16, typename Tiles>
__device__ __forceinline__ void run_tiles(int* smem, const Tiles& tiles) {
  const int* table = smem;
  const int wh = table[6];
  const int ww = table[7];
  float* in = stage0(smem, table_len(table), table[8]);
  int t = blockIdx.x;
  if (t >= tiles.n_tiles) return;
  stage<T>(tiles.gather(t), in, wh, ww);
  for (; t < tiles.n_tiles; t += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();
    walk<kE, kBf16>(table, in, tiles.sink(t));
    const int next = t + gridDim.x;
    if (next < tiles.n_tiles) stage<T>(tiles.gather(next), in, wh, ww);
  }
}

// Tiles of four (B, hp, wp) planes at block bh x bw with halo r.
struct TileGrid {
  int hp, wp, bh, bw, r, gx, gy, n_tiles;
  __device__ __forceinline__ TileGrid(int batch, int hp_, int wp_, int bh_,
                                      int bw_, int r_)
      : hp(hp_), wp(wp_), bh(bh_), bw(bw_), r(r_),
        gx((wp_ + bw_ - 1) / bw_), gy((hp_ + bh_ - 1) / bh_),
        n_tiles(batch * gx * gy) {}
  __device__ __forceinline__ Geom geom(int t) const {
    Geom g;
    g.hp = hp;
    g.wp = wp;
    g.bh = bh;
    g.bw = bw;
    g.r = r;
    g.x0 = (t % gx) * bw;
    g.y0 = ((t / gx) % gy) * bh;
    g.base = static_cast<size_t>(t / (gx * gy)) * hp * wp;
    g.interior = g.y0 >= r && g.y0 + bh + r <= hp && g.x0 >= r &&
                 g.x0 + bw + r <= wp;
    return g;
  }
};

// Output policy: the tile core of the four output planes.
template <typename T>
struct CoreSink {
  OutPlanes out;
  Geom g;
  __device__ __forceinline__ void operator()(int mask, int y, int x,
                                             float v) const {
    store_core<T>(out, mask, g, y, x, v);
  }
};

// --- address policies of the fused-pyramid kernels --------------------

// Input policy: four (B, hp, wp) planes, gathered mod hp / mod wp at the
// edges (K3's LL, HL, LH, HH).
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

// Input policy of the split folded into the gather (K2): for plane j of
// level l's image, window sample (y, x) of the tile is image
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

// Output policy of the merge folded into the sink (K3): output k at plane
// position (gy, gx) of the tile core goes to pixel
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

}  // namespace window
