// Device functions shared by the window kernel (tap_window.cu, K1) and the
// fused-pyramid kernels (pyramid_window.cu, K2 and K3): the walk of one
// encoded tap-program table over a window held in shared memory.
//
// Program table of one window (int32, built by tap_window.encode and
// pyramid_window.encode_pyramid):
//   header  n_nodes, n_terms, n_slots, halo
//   node    kind, j, dst slot (-1 = none), qm, qn, first term, n terms,
//           output mask                                  (8 ints each)
//   term    src offset, op, coefficient bits, 0          (4 ints each)
// A node's region is window rows [qn, wh - qn) x cols [qm, ww - qm); a
// term reads its source slot at  pos + src offset, where the offset folds
// the source slot base and the (km, kn) shift:  slot*wh*ww - kn*ww - km.
// The block's 256 threads walk a region as a flat index, kElems
// positions per thread at a time, so one read of a term serves kElems
// independent accumulators.  The caller puts a barrier between
// consecutive nodes: consumers read producers at shifted positions.
//
// Where the inputs come from and where the outputs go differs between
// the kernels, so both walks take two policies:
//   Src   typename Src::Idx; Idx index(int y, int x) const;
//         float load(int j, Idx idx) const   (input plane j at the index)
//   Sink  void operator()(int mask, int y, int x, float v) const
//         (window position (y, x) of an output node, ``mask`` its bits)
//
// Arithmetic: terms accumulate left to right with __fmul_rn / __fadd_rn
// (no FMA contraction); c == 1 skips the multiply and c == -1 negates,
// exactly as the plain versions do.  With bf16 compute every product
// and sum is rounded to bfloat16 (float32 holds more than 2*8+2
// significand bits, so the emulation is exact).
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace window {

constexpr int kHeader = 4;
constexpr int kNodeInts = 8;
constexpr int kInput = 0;
constexpr int kCopy = 0;
constexpr int kNeg = 1;
constexpr int kThreads = 256;
// window positions each thread carries through one pass of a node's term
// list: the term is read from the table once for all of them, and the
// loads of a pass are independent of each other
constexpr int kElems = 4;

struct InPlanes { const void* p[4]; };
struct OutPlanes { void* p[4]; };

// Where a block's window sits: plane sizes, block core, halo.
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

// Store window position (y, x) to every output plane in ``mask`` if it
// lies in the block core and inside the plane (the ragged edge is masked).
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

// A run of ``run`` (<= 4) consecutive input nodes: fill their slots over
// the whole wh x ww window from ``src`` (rounded to the compute dtype)
// and hand output positions to ``sink``.
template <bool kBf16, typename Src, typename Sink>
__device__ __forceinline__ void load_inputs(const int* nd, int run,
                                            const Src& src, const Sink& sink,
                                            float* slots, int wh, int ww) {
  const int plane = wh * ww;
  const float inv_w = 1.0f / ww;
  for (int i0 = threadIdx.x; i0 < plane; i0 += kThreads * kElems) {
    int ys[kElems], xs[kElems];
    typename Src::Idx idx[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = min(i0 + e * kThreads, plane - 1);
      ys[e] = row_of(i, inv_w);
      xs[e] = i - ys[e] * ww;
      idx[e] = src.index(ys[e], xs[e]);
    }
    float v[4][kElems];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < run) {
        const int j = nd[k * kNodeInts + 1];
#pragma unroll
        for (int e = 0; e < kElems; ++e) v[k][e] = src.load(j, idx[e]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= run) break;
      const int dst = nd[k * kNodeInts + 2];
      const int mask = nd[k * kNodeInts + 7];
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        if (i0 + e * kThreads >= plane) break;
        const float x = round_c<kBf16>(v[k][e]);
        if (dst >= 0) slots[dst * plane + ys[e] * ww + xs[e]] = x;
        if (mask) sink(mask, ys[e], xs[e], x);
      }
    }
  }
}

// One lincomb node over its region: terms accumulate left to right.
template <bool kBf16, typename Sink>
__device__ __forceinline__ void eval_node(const int* nd, const int4* terms,
                                          float* slots, int wh, int ww,
                                          const Sink& sink) {
  const int dst = nd[2];
  const int qm = nd[3];
  const int qn = nd[4];
  const int t0 = nd[5];
  const int nt = nd[6];
  const int mask = nd[7];
  const int plane = wh * ww;
  const int rw = ww - 2 * qm;
  const int count = rw * (wh - 2 * qn);
  const float inv_w = 1.0f / rw;
  for (int i0 = threadIdx.x; i0 < count; i0 += kThreads * kElems) {
    int ys[kElems], xs[kElems], pos[kElems];
    float acc[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = min(i0 + e * kThreads, count - 1);
      const int y = row_of(i, inv_w);
      ys[e] = y + qn;
      xs[e] = i - y * rw + qm;
      pos[e] = ys[e] * ww + xs[e];
      acc[e] = 0.0f;
    }
    for (int t = 0; t < nt; ++t) {
      const int4 tm = terms[t0 + t];
      const float c = __int_as_float(tm.z);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const float s = slots[pos[e] + tm.x];
        float v;
        if (tm.y == kCopy) {
          v = s;
        } else if (tm.y == kNeg) {
          v = -s;
        } else {
          v = round_c<kBf16>(__fmul_rn(s, c));
        }
        acc[e] = t == 0 ? v : round_c<kBf16>(__fadd_rn(acc[e], v));
      }
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      if (i0 + e * kThreads >= count) break;
      if (dst >= 0) slots[dst * plane + pos[e]] = acc[e];
      if (mask) sink(mask, ys[e], xs[e], acc[e]);
    }
  }
}

// Walk the nodes of one table (already in shared memory) over a wh x ww
// window: runs of input nodes load from ``src``, lincomb nodes evaluate,
// a barrier after each.
template <bool kBf16, typename Src, typename Sink>
__device__ __forceinline__ void walk(const int* table, const Src& src,
                                     const Sink& sink, float* slots, int wh,
                                     int ww) {
  const int n_nodes = table[0];
  const int* nodes = table + kHeader;
  const int4* terms =
      reinterpret_cast<const int4*>(nodes + n_nodes * kNodeInts);
  int n = 0;
  while (n < n_nodes) {
    const int* nd = nodes + n * kNodeInts;
    if (nd[0] == kInput) {
      int run = 1;
      while (n + run < n_nodes && run < 4 &&
             nodes[(n + run) * kNodeInts] == kInput) {
        ++run;
      }
      load_inputs<kBf16>(nd, run, src, sink, slots, wh, ww);
      n += run;
    } else {
      eval_node<kBf16>(nd, terms, slots, wh, ww, sink);
      ++n;
    }
    __syncthreads();
  }
}

}  // namespace window
