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
// Program table (int32, built by tap_window.encode):
//   header  n_nodes, n_terms, n_slots, halo
//   node    kind, j, dst slot (-1 = none), qm, qn, first term, n terms,
//           output mask                                  (8 ints each)
//   term    src offset, op, coefficient bits, 0          (4 ints each)
// A node's region is window rows [qn, wh - qn) x cols [qm, ww - qm); a
// term reads its source slot at  pos + src offset, where the offset folds
// the source slot base and the (km, kn) shift:  slot*wh*ww - kn*ww - km.
// The block's 256 threads walk a region as a flat index, kElems
// positions per thread at a time, so one read of a term serves kElems
// independent accumulators.  A barrier separates consecutive nodes:
// consumers read producers at shifted positions.
//
// Arithmetic: terms accumulate left to right with __fmul_rn / __fadd_rn
// (no FMA contraction); c == 1 skips the multiply and c == -1 negates,
// exactly as the plain version does.  With bf16 compute every product
// and sum is rounded to bfloat16 (float32 holds more than 2*8+2
// significand bits, so the emulation is exact).
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

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

// Where this block's window sits: plane sizes, block core, halo.
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

template <bool kBf16>
__device__ __forceinline__ float round_c(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ int wrap(int v, int n) {
  int m = v % n;
  return m < 0 ? m + n : m;
}

// Row of flat index i in a region ``w`` wide: floor((i + 0.5) / w) in
// float.  Exact while block edges stay <= 256 (tap_window.encode refuses
// larger ones) and the halo small: w and the quotient are then below
// 2^9, so the quotient's rounding error (< 2^-22 relative, < 2^-13) stays
// under 0.5 / w, its distance to the nearest integer.
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

// A run of ``run`` (<= 4) consecutive input nodes: gather their windows
// from the unpadded planes (mod-hp / mod-wp at the plane edges).
template <typename T, bool kBf16>
__device__ __forceinline__ void load_inputs(const int* nd, int run,
                                            const InPlanes& in,
                                            const OutPlanes& out,
                                            float* slots, const Geom& g) {
  const int ww = g.bw + 2 * g.r;
  const int plane = (g.bh + 2 * g.r) * ww;
  const float inv_w = 1.0f / ww;
  for (int i0 = threadIdx.x; i0 < plane; i0 += kThreads * kElems) {
    int ys[kElems], xs[kElems];
    size_t src[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = min(i0 + e * kThreads, plane - 1);
      ys[e] = row_of(i, inv_w);
      xs[e] = i - ys[e] * ww;
      int gy = g.y0 - g.r + ys[e];
      int gx = g.x0 - g.r + xs[e];
      if (!g.interior) {
        gy = wrap(gy, g.hp);
        gx = wrap(gx, g.wp);
      }
      src[e] = g.base + static_cast<size_t>(gy) * g.wp + gx;
    }
    float v[4][kElems];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < run) {
        const T* p = static_cast<const T*>(in.p[nd[k * kNodeInts + 1]]);
#pragma unroll
        for (int e = 0; e < kElems; ++e) v[k][e] = to_float(p[src[e]]);
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
        if (mask) store_core<T>(out, mask, g, ys[e], xs[e], x);
      }
    }
  }
}

// One lincomb node over its region: terms accumulate left to right.
template <typename T, bool kBf16>
__device__ __forceinline__ void eval_node(const int* nd, const int4* terms,
                                          float* slots, const OutPlanes& out,
                                          const Geom& g) {
  const int dst = nd[2];
  const int qm = nd[3];
  const int qn = nd[4];
  const int t0 = nd[5];
  const int nt = nd[6];
  const int mask = nd[7];
  const int ww = g.bw + 2 * g.r;
  const int plane = (g.bh + 2 * g.r) * ww;
  const int rw = ww - 2 * qm;
  const int count = rw * (g.bh + 2 * g.r - 2 * qn);
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
      if (mask) store_core<T>(out, mask, g, ys[e], xs[e], acc[e]);
    }
  }
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
tap_window_kernel(const int* __restrict__ table, int table_ints,
                  int n_nodes, InPlanes in, OutPlanes out, int hp, int wp,
                  int bh, int bw, int r) {
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
  const int* nodes = smem + kHeader;
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
      load_inputs<T, kBf16>(nd, run, in, out, slots, g);
      n += run;
    } else {
      eval_node<T, kBf16>(nd, terms, slots, out, g);
      ++n;
    }
    __syncthreads();
  }
}

template <typename T, bool kBf16>
cudaError_t launch(const int* table, int table_ints, int n_nodes,
                   const InPlanes& in, const OutPlanes& out, int batch,
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
  kernel<<<grid, kThreads, smem, stream>>>(table, table_ints, n_nodes, in,
                                           out, hp, wp, bh, bw, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// io_dtype: 0 float32, 1 float16, 2 bfloat16; device: the CUDA ordinal
// the stream belongs to.  Returns a cudaError_t.
int tap_window_launch(const int* table, int table_ints, int n_nodes,
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
      bf ? launch<T, true>(table, table_ints, n_nodes, in, out, batch, hp,  \
                           wp, bh, bw, r, n_slots, s)                       \
         : launch<T, false>(table, table_ints, n_nodes, in, out, batch, hp, \
                            wp, bh, bw, r, n_slots, s))
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
