// Temporal lifting kernel: one whole level of the 3-D (t+2D) transform's
// 1-D lifting pass along T, forward or inverse, in one launch.
//
// Replaces no TPU kernel: the reference package runs this pass as jnp
// between its Pallas kernels (repro/compiler/temporal.py), which XLA fuses
// on the TPU; run as one torch op per tap it moved about 15 times the
// bytes it needs.  Bound by device-memory bytes on an H100: a level reads
// every sample once and writes it once, with a few flops per sample.
// What the design does about that:
//
// * each thread owns one column of the contiguous (H, W) plane, a block
//   128 neighbouring columns, so a warp's every load and store of a frame
//   is 128 contiguous bytes (for float I/O);
// * a block walks one chunk of frame pairs along T (an even split of the
//   T/2 pairs, 32 or more each): it stages the chunk's even (s) and odd
//   (d) frames, with the program's halo on both sides, in shared memory
//   that is column-private (frame-major, one float per thread per frame:
//   every access a conflict-free wavefront, and no barrier anywhere), runs
//   every lifting step of the program there and writes only the chunk's
//   own pairs.  The halo is recomputed, not exchanged: the summed one-sided
//   reach of the program's steps (2 pairs a side for 9/7), so the over-read
//   stays at or below 12.5% of the reads;
// * float inputs reach shared memory through cp.async, every load of a
//   thread in flight at once; 16-bit inputs through registers;
// * the periodic wrap is mod-(T/2) indexing of the loads, right also when
//   T/2 is smaller than the halo;
// * each side (the forward's interleaved input and two half-band outputs,
//   the inverse's two half-band inputs and interleaved output) is a base
//   pointer, a frame stride and a batch stride, so one kernel serves both
//   directions and no interleave or split is copied.
//
// The program comes as a small int table (temporal_lift.py::table_rows):
// one build serves every wavelet.  Products and sums use __fmul_rn /
// __fadd_rn in the plain version's order (taps sorted by k, each added on
// its own), so the two agree bit for bit in float32; with bf16 compute
// every product and sum is rounded to bfloat16, which float32 emulates
// exactly.
#include "window_common.cuh"

namespace {

using window::from_float;
using window::round_c;
using window::to_float;
using window::wrap;

// columns per block
constexpr int kThreads = 128;
// table layout, shared with kernels/temporal_lift.py
constexpr int kHeader = 8;     // steps, s before/after, d before/after,
                               // scale mode, s scale bits, d scale bits
constexpr int kMaxTaps = 4;
constexpr int kStepInts = 4 + 2 * kMaxTaps;  // target, before, after, taps,
                                             // (offset, coef bits) x 4
// frames a thread loads through registers before it stores them
constexpr int kStage = 8;

struct Side {
  void* p;
  long long frame;  // elements between two consecutive frames of the side
  long long batch;  // elements between two consecutive volumes
};

// Frames [first, first + n) of one side (mod pairs), bound for a column of
// shared memory (frame f at buf[f * kThreads]); k scales them on the way
// in where the program scales first (the inverse).
template <typename T>
struct Band {
  float* buf;
  const T* base;  // the column in the side's volume
  long long frame;
  int first, n;
  float k;
};

// Float inputs: request every frame of the band through cp.async.
__device__ __forceinline__ void request(const Band<float>& b, int pairs) {
  int g = wrap(b.first, pairs);
  for (int i = 0; i < b.n; ++i) {
    __pipeline_memcpy_async(b.buf + i * kThreads, b.base + g * b.frame,
                            sizeof(float));
    if (++g == pairs) g = 0;
  }
}

// Round a staged float band to the compute dtype, then scale it.
template <bool kBf16>
__device__ __forceinline__ void settle(const Band<float>& b, bool scale) {
  for (int i = 0; i < b.n; ++i) {
    float v = round_c<kBf16>(b.buf[i * kThreads]);
    if (scale) v = round_c<kBf16>(__fmul_rn(v, b.k));
    b.buf[i * kThreads] = v;
  }
}

// 16-bit inputs: through registers, kStage frames in flight at a time.
template <typename T, bool kBf16>
__device__ __forceinline__ void load(const Band<T>& b, int pairs,
                                     bool scale) {
  int g = wrap(b.first, pairs);
  for (int i0 = 0; i0 < b.n; i0 += kStage) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (i0 + u < b.n) {
        v[u] = round_c<kBf16>(to_float(b.base[g * b.frame]));
      }
      if (++g == pairs) g = 0;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (i0 + u < b.n) {
        float x = v[u];
        if (scale) x = round_c<kBf16>(__fmul_rn(x, b.k));
        b.buf[(i0 + u) * kThreads] = x;
      }
    }
  }
}

// Stage both bands of a chunk in the compute dtype, scaled when `scale`.
template <typename T, bool kBf16>
__device__ __forceinline__ void stage(const Band<T>& s, const Band<T>& d,
                                      int pairs, bool scale) {
  if constexpr (std::is_same<T, float>::value) {
    request(s, pairs);
    request(d, pairs);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    if (kBf16 || scale) {
      settle<kBf16>(s, scale);
      settle<kBf16>(d, scale);
    }
  } else {
    load<T, kBf16>(s, pairs, scale);
    load<T, kBf16>(d, pairs, scale);
  }
}

// Write frames [0, n) of a column to pairs [c0, c0 + n) of one side,
// scaled by k when `scale` (the forward scales after its steps).
template <typename T, bool kBf16>
__device__ __forceinline__ void drain(const float* buf, T* base,
                                      long long frame, int c0, int n,
                                      bool scale, float k) {
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    float v = buf[i * kThreads];
    if (scale) v = round_c<kBf16>(__fmul_rn(v, k));
    from_float(base + (c0 + i) * frame, v);
  }
}

// One lifting step over positions [lo, hi) of the chunk:
// t[i] += c_j * s[i + o_j], tap by tap in table order.
template <int kTaps, bool kBf16>
__device__ __forceinline__ void lift(float* t, const float* s,
                                     const int* __restrict__ st, int lo,
                                     int hi) {
  int off[kTaps];
  float c[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    off[j] = __ldg(st + 4 + 2 * j) * kThreads;
    c[j] = __int_as_float(__ldg(st + 5 + 2 * j));
  }
#pragma unroll 2
  for (int i = lo; i < hi; ++i) {
    const int at = i * kThreads;
    float acc = t[at];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      acc = round_c<kBf16>(
          __fadd_rn(acc, round_c<kBf16>(__fmul_rn(s[at + off[j]], c[j]))));
    }
    t[at] = acc;
  }
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
temporal_lift_kernel(const int* __restrict__ table, Side s_in, Side d_in,
                     Side s_out, Side d_out, int batch, int pairs,
                     long long plane, int chunks) {
  extern __shared__ float smem[];
  const long long col = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (col >= plane) return;  // no barrier follows: columns are private
  const int c0 = static_cast<int>(
      static_cast<long long>(blockIdx.y) * pairs / chunks);
  const int len = static_cast<int>(
      static_cast<long long>(blockIdx.y + 1) * pairs / chunks) - c0;
  const int n_steps = __ldg(table);
  const int sb = __ldg(table + 1), sa = __ldg(table + 2);
  const int db = __ldg(table + 3), da = __ldg(table + 4);
  const int scale_mode = __ldg(table + 5);  // 0 none, 1 after, 2 before
  const float ks = __int_as_float(__ldg(table + 6));
  const float kd = __int_as_float(__ldg(table + 7));
  // position i of the chunk (pair c0 + i) at s[i * kThreads], d[...]
  float* s = smem + threadIdx.x + sb * kThreads;
  float* d = smem + threadIdx.x + (sb + len + sa + db) * kThreads;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    stage<T, kBf16>(
        Band<T>{s - sb * kThreads,
                static_cast<const T*>(s_in.p) + b * s_in.batch + col,
                s_in.frame, c0 - sb, sb + len + sa, ks},
        Band<T>{d - db * kThreads,
                static_cast<const T*>(d_in.p) + b * d_in.batch + col,
                d_in.frame, c0 - db, db + len + da, kd},
        pairs, scale_mode == 2);
    for (int j = 0; j < n_steps; ++j) {
      const int* st = table + kHeader + j * kStepInts;
      const bool to_d = __ldg(st) != 0;
      float* t = to_d ? d : s;
      const float* from = to_d ? s : d;
      const int lo = -__ldg(st + 1), hi = len + __ldg(st + 2);
      switch (__ldg(st + 3)) {
        case 1: lift<1, kBf16>(t, from, st, lo, hi); break;
        case 2: lift<2, kBf16>(t, from, st, lo, hi); break;
        case 3: lift<3, kBf16>(t, from, st, lo, hi); break;
        case 4: lift<4, kBf16>(t, from, st, lo, hi); break;
        default: break;
      }
    }
    drain<T, kBf16>(s, static_cast<T*>(s_out.p) + b * s_out.batch + col,
                    s_out.frame, c0, len, scale_mode == 1, ks);
    drain<T, kBf16>(d, static_cast<T*>(d_out.p) + b * d_out.batch + col,
                    d_out.frame, c0, len, scale_mode == 1, kd);
  }
}

template <typename T, bool kBf16>
cudaError_t launch(const int* table, const Side& s_in, const Side& d_in,
                   const Side& s_out, const Side& d_out, int batch,
                   int pairs, long long plane, int chunks, int frames,
                   cudaStream_t stream, int* info) {
  auto kernel = temporal_lift_kernel<T, kBf16>;
  const int smem = frames * kThreads * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  static_cast<unsigned>(chunks),
                  static_cast<unsigned>(batch < 65535 ? batch : 65535));
  if (info != nullptr) {
    const long long blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
    info[0] = static_cast<int>(blocks < 2147483647LL ? blocks : 2147483647LL);
    info[1] = per_sm;
  }
  kernel<<<grid, kThreads, smem, stream>>>(table, s_in, d_in, s_out, d_out,
                                           batch, pairs, plane, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each side is a base pointer with its frame and batch strides in
// elements: the forward reads s and d from one interleaved volume (base
// and base + frame stride, strides 2 x and the volume's) and writes two
// half-band volumes; the inverse the other way round.  pairs: T/2;
// plane: H * W; chunks: the split of the pairs along T (gridDim.y);
// frames: the shared-memory floats per thread (the longest chunk's s and
// d with their halos); io_dtype: 0 float32, 1 float16, 2 bfloat16;
// device: the CUDA ordinal the stream belongs to; info: receives the
// grid's blocks and the resident blocks per SM (may be null).  Returns a
// cudaError_t.
int temporal_lift_launch(const int* table,
                         const void* s_in, long long s_in_frame,
                         long long s_in_batch,
                         const void* d_in, long long d_in_frame,
                         long long d_in_batch,
                         void* s_out, long long s_out_frame,
                         long long s_out_batch,
                         void* d_out, long long d_out_frame,
                         long long d_out_batch,
                         int batch, int pairs, long long plane, int chunks,
                         int frames, int io_dtype, int bf16_compute,
                         int device, void* stream, int* info) {
  // this library carries its own runtime: point it at the stream's device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  const Side si{const_cast<void*>(s_in), s_in_frame, s_in_batch};
  const Side di{const_cast<void*>(d_in), d_in_frame, d_in_batch};
  const Side so{s_out, s_out_frame, s_out_batch};
  const Side dout{d_out, d_out_frame, d_out_batch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = bf16_compute != 0;
#define TEMPORAL_LIFT_LAUNCH(T)                                            \
  return static_cast<int>(                                                 \
      bf ? launch<T, true>(table, si, di, so, dout, batch, pairs, plane,   \
                           chunks, frames, st, info)                       \
         : launch<T, false>(table, si, di, so, dout, batch, pairs, plane,  \
                            chunks, frames, st, info))
  switch (io_dtype) {
    case 0: TEMPORAL_LIFT_LAUNCH(float);
    case 1: TEMPORAL_LIFT_LAUNCH(__half);
    case 2: TEMPORAL_LIFT_LAUNCH(__nv_bfloat16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TEMPORAL_LIFT_LAUNCH
}

const char* temporal_lift_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
