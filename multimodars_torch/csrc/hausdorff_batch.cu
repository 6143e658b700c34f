// Batched masked squared Hausdorff distance against shared reference sets,
// hand-written for Hopper (sm_90a).
//
// What it computes, for every candidate c = 0 .. C-1 with reference slot
// s = c / K (K candidates share one reference set):
//
//   fwd = max over valid rows i of p[c] of (min over valid j of d2(p[c,i], q[s,j]))
//   bwd = max over valid rows j of q[s] of (min over valid i of the same d2)
//   out[c] = max(fwd, bwd); 0 where either set is empty.
//
// This is ops/hausdorff.py::hausdorff_sq_masked of the JAX package in the
// use of pipelines/centerline_align.py::refine_alignment_hausdorff, which
// broadcasts every shift's filtered CCTA cloud to its K angle candidates and
// evaluates [S*K, n, m] as one XLA program.  It is not a Pallas kernel; on
// this card it needs one because its sets are far larger than the sweep
// kernel's (csrc/sweep_cost.cu keeps both sets whole in shared memory,
// which caps them at a few thousand points a side): a tube cloud around a
// 56 mm coronary segment keeps ~7k-16k points after the bounding-box
// filter, and the candidates are as many, so one call holds ~2e10 pairs and
// the plain version's [S*K, n, m] tile would not fit on the card.
//
// Design.  One block owns (candidate, direction, tile of kRowsPerBlock rows
// of its outer set): direction 0 takes rows of p[c] against q[s], direction
// 1 rows of q[s] against p[c].  Each thread keeps kRowsPerThread rows and
// their running minima in registers, and the block streams the inner set
// through shared memory in fixed tiles of kTile points, so no size cap comes
// from shared memory.  Invalid inner points are stored as (+inf, +inf),
// whose d2 is +inf and never wins a minimum; whether the inner set has any
// valid point at all is decided explicitly (__syncthreads_or) and a block
// over an empty inner set contributes nothing.  The row minima reduce to a
// block maximum, which is merged into the candidate's output with one
// atomicMax on the bit pattern of the non-negative float (non-negative IEEE
// values order like their bits); the wrapper zeroes the output first, so an
// empty set on either side leaves 0.
//
// d2 = (px - qx)^2 + (py - qy)^2 is evaluated with the round-to-nearest
// intrinsics (__fsub_rn/__fmul_rn/__fadd_rn, __dsub_rn/__dmul_rn/__dadd_rn),
// which nvcc never contracts into an FMA: every f64 d2 equals numpy's
// dx*dx + dy*dy bit for bit, min and max are exact, so the f64 table equals
// the host's exact f64 table.
//
// What bounds it on this card: instruction throughput, not device memory.  Each
// pair costs 5 rounded operations and a compare; each inner point is read
// once from shared memory per thread (a broadcast) and used for
// kRowsPerThread rows.  Tensor cores, TMA and a tighter register tiling are
// left for later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTile = 1024;

template <typename T> struct Traits;
template <> struct Traits<float> {
  using Vec = float2;
  using Bits = unsigned int;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float d2(float px, float py, float2 q) {
    const float dx = __fsub_rn(px, q.x);
    const float dy = __fsub_rn(py, q.y);
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
};
template <> struct Traits<double> {
  using Vec = double2;
  using Bits = unsigned long long;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double d2(double px, double py, double2 q) {
    const double dx = __dsub_rn(px, q.x);
    const double dy = __dsub_rn(py, q.y);
    return __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy));
  }
  static __device__ __forceinline__ Bits bits(double v) {
    return (unsigned long long)__double_as_longlong(v);
  }
};

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const T other = __shfl_xor_sync(0xffffffffu, v, offset);
    v = other > v ? other : v;
  }
  return v;
}

// grid (C, ceil(max(n, m) / kRowsPerBlock), 2), block kThreads: candidates
// on x (up to 2^31 - 1 of them), row tiles on y, the direction on z.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hausdorff_batch_kernel(const T* __restrict__ p, const uint8_t* __restrict__ pmask,
                       const T* __restrict__ q, const uint8_t* __restrict__ qmask,
                       typename Traits<T>::Bits* __restrict__ out, int n, int m,
                       int K) {
  using V = typename Traits<T>::Vec;
  __shared__ V tile[kTile];
  __shared__ T red[kWarps];

  const int c = blockIdx.x;
  const int s = c / K;
  const bool forward = blockIdx.z == 0;
  const V* p_c = reinterpret_cast<const V*>(p) + (size_t)c * n;
  const V* q_s = reinterpret_cast<const V*>(q) + (size_t)s * m;
  const uint8_t* pm_c = pmask + (size_t)c * n;
  const uint8_t* qm_s = qmask + (size_t)s * m;
  const V* rows = forward ? p_c : q_s;
  const uint8_t* row_mask = forward ? pm_c : qm_s;
  const int n_rows = forward ? n : m;
  const V* inner = forward ? q_s : p_c;
  const uint8_t* inner_mask = forward ? qm_s : pm_c;
  const int n_inner = forward ? m : n;

  const int row0 = blockIdx.y * kRowsPerBlock;
  if (row0 >= n_rows) return;  // the same for every thread of the block

  const int tid = threadIdx.x;
  const T inf = Traits<T>::inf();
  T px[kRowsPerThread], py[kRowsPerThread], mn[kRowsPerThread];
  bool live[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r * kThreads + tid;
    live[r] = i < n_rows && row_mask[i] != 0;
    const V v = live[r] ? rows[i] : V{T(0), T(0)};
    px[r] = v.x;
    py[r] = v.y;
    mn[r] = inf;
  }

  int any_inner = 0;
  for (int j0 = 0; j0 < n_inner; j0 += kTile) {
    const int len = min(kTile, n_inner - j0);
    __syncthreads();  // the previous tile is consumed
    int any = 0;
    for (int j = tid; j < len; j += kThreads) {
      V v = inner[j0 + j];
      if (inner_mask[j0 + j] != 0) {
        any = 1;
      } else {
        v.x = inf;
        v.y = inf;
      }
      tile[j] = v;
    }
    any_inner |= __syncthreads_or(any);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const V b = tile[j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const T d = Traits<T>::d2(px[r], py[r], b);
        mn[r] = d < mn[r] ? d : mn[r];
      }
    }
  }
  if (!any_inner) return;  // empty inner set: the candidate stays 0

  T best = T(0);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    if (live[r] && mn[r] > best) best = mn[r];
  best = warp_max(best);
  if ((tid & 31) == 0) red[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    T v = red[0];
    for (int w = 1; w < kWarps; ++w) v = red[w] > v ? red[w] : v;
    if (v > T(0)) atomicMax(out + c, Traits<T>::bits(v));
  }
}

template <typename T>
int launch(const T* p, const uint8_t* pmask, const T* q, const uint8_t* qmask,
           void* out, int C, int n, int m, int K, void* stream) {
  const int rows = n > m ? n : m;
  const dim3 grid(C, (rows + kRowsPerBlock - 1) / kRowsPerBlock, 2);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  hausdorff_batch_kernel<T><<<grid, kThreads, 0, st>>>(
      p, pmask, q, qmask, reinterpret_cast<typename Traits<T>::Bits*>(out), n,
      m, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mm_hausdorff_batch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out: C zeroed 32-bit words, read afterwards as float32
int mm_hausdorff_batch_f32(const float* p, const uint8_t* pmask, const float* q,
                           const uint8_t* qmask, void* out, int C, int n, int m,
                           int K, void* stream) {
  return launch<float>(p, pmask, q, qmask, out, C, n, m, K, stream);
}

// out: C zeroed 64-bit words, read afterwards as float64
int mm_hausdorff_batch_f64(const double* p, const uint8_t* pmask,
                           const double* q, const uint8_t* qmask, void* out,
                           int C, int n, int m, int K, void* stream) {
  return launch<double>(p, pmask, q, qmask, out, C, n, m, K, stream);
}

}  // extern "C"
