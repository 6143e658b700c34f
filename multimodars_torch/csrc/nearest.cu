// Nearest neighbour with runner-up, hand-written for Hopper (sm_90a).
//
// What it computes, for every row i of a [N, 3] against b [M, 3] (M >= 1;
// both centred at one float64 midpoint by the wrapper, then cast):
//
//   d2(i, j) = ((ax - bx)^2 + (ay - by)^2) + (az - bz)^2
//   m1[i]    = min_j d2(i, j)
//   idx[i]   = the first j that attains m1 (int64, never bit-cast into a float)
//   m2[i]    = min over j != idx[i] of d2(i, j)  (+inf when M = 1; equal to
//              m1 when a later j ties the minimum)
//
// These are the semantics of _min_sqdist_block2 of the JAX package
// (ccta/kernels.py:73; _min_sqdist_block :67 is its m1/idx
// part).  The wrapper re-picks in float64 on the host every row whose m2 - m1
// lies within the compute dtype's rounding band, as _min_sqdist_device_finish
// (:843) does, and recomputes the winning distance exactly.
//
// Design.  One thread owns one row of a in registers with its (m1, idx, m2);
// the block streams b through shared memory in tiles of kTile points in
// index order, so no size cap comes from shared memory, and each thread
// scans j in increasing order with strict compares: the first j to attain
// the minimum keeps it, and every other candidate, a later tie included,
// lowers m2.  Since min is exact, m1 and m2 do not depend on the tiling; in
// float64 the kernel equals the plain version bit for bit, indices included.
// d2 is evaluated with round-to-nearest intrinsics (no FMA contraction), the
// form the certification band was derived for.
//
// What bounds it on this card: FP32 (FP64) instruction throughput.  Each pair costs the d2
// (3 sub, 3 mul, 2 add), a compare for the minimum, selects for the index
// and the runner-up and a compare for the runner-up.  The main path's sets
// are small (region vertices against a 50-60 point centerline, a few
// thousand points against a few hundred), so launches are short and latency
// more than the pipe bounds them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

struct alignas(16) F4 { float x, y, z, w; };
struct alignas(32) D4 { double x, y, z, w; };

template <typename T> struct Traits;
template <> struct Traits<float> {
  using Vec = F4;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float d2(float ax, float ay, float az, F4 b) {
    const float dx = __fsub_rn(ax, b.x);
    const float dy = __fsub_rn(ay, b.y);
    const float dz = __fsub_rn(az, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
};
template <> struct Traits<double> {
  using Vec = D4;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double d2(double ax, double ay, double az, D4 b) {
    const double dx = __dsub_rn(ax, b.x);
    const double dy = __dsub_rn(ay, b.y);
    const double dz = __dsub_rn(az, b.z);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
  }
};

// grid ceil(N / kThreads), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const T* __restrict__ a, const T* __restrict__ b, int n, int m,
               T* __restrict__ m1_out, T* __restrict__ m2_out,
               int64_t* __restrict__ idx_out) {
  using V = typename Traits<T>::Vec;
  __shared__ V tile[kTile];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const bool live = i < n;
  const T ax = live ? a[3 * (size_t)i] : T(0);
  const T ay = live ? a[3 * (size_t)i + 1] : T(0);
  const T az = live ? a[3 * (size_t)i + 2] : T(0);
  T m1 = Traits<T>::inf(), m2 = Traits<T>::inf();
  int best = 0;

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();  // the previous tile is consumed
    for (int j = tid; j < len; j += kThreads) {
      const size_t o = 3 * (size_t)(j0 + j);
      tile[j] = V{b[o], b[o + 1], b[o + 2], T(0)};
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const T d = Traits<T>::d2(ax, ay, az, tile[j]);
      const bool lower = d < m1;
      m2 = lower ? m1 : (d < m2 ? d : m2);
      best = lower ? j0 + j : best;
      m1 = lower ? d : m1;
    }
  }
  if (live) {
    m1_out[i] = m1;
    m2_out[i] = m2;
    idx_out[i] = best;
  }
}

template <typename T>
int launch(const T* a, const T* b, int n, int m, T* m1, T* m2, int64_t* idx,
           void* stream) {
  if (n == 0) return 0;
  if (m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  nearest_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a, b, n, m, m1, m2, idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mm_nearest_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int mm_nearest_f32(const float* a, const float* b, int n, int m, float* m1, float* m2,
                   int64_t* idx, void* stream) {
  return launch<float>(a, b, n, m, m1, m2, idx, stream);
}

int mm_nearest_f64(const double* a, const double* b, int n, int m, double* m1,
                   double* m2, int64_t* idx, void* stream) {
  return launch<double>(a, b, n, m, m1, m2, idx, stream);
}

}  // extern "C"
