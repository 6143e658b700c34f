// Nearest neighbour with runner-up, hand-written for Hopper (sm_90a).
//
// What it computes, for each pair p of one launch and every row i of its a
// set [n, 3] against its b set [m, 3] (m >= 1; both centred at the pair's
// float64 midpoint by the caller, then cast):
//
//   d2(i, j) = ((ax - bx)^2 + (ay - by)^2) + (az - bz)^2
//   m1[i]    = min_j d2(i, j)
//   idx[i]   = the first j that attains m1 (int64, never bit-cast into a float)
//   m2[i]    = min over j != idx[i] of d2(i, j)  (+inf when m = 1; equal to
//              m1 when a later j ties the minimum)
//
// These are the semantics of _min_sqdist_block2 of the JAX package
// (ccta/kernels.py:73; _min_sqdist_block :67 is its m1/idx
// part).  The caller re-picks in float64 on the host every row whose m2 - m1
// lies within the compute dtype's rounding band, as _min_sqdist_device_finish
// (:843) does, and recomputes the winning distance exactly.
//
// What bounds it on this card: FP32 (FP64) instruction throughput in
// principle (the d2, a compare for the minimum, selects for the index and
// the runner-up and a compare for the runner-up); on the main path's sets
// (a few thousand rows against tens to hundreds of points) the launch's
// latency and the number of blocks in flight bound it instead.
//
// Design.
// - One launch takes up to kMaxPairs pairs from a table passed by value; a
//   block holds kThreads / L rows of one pair.
// - L lanes (a power of two up to 32, chosen per pair by
//   ops/nearest.py::plan_lanes) share a row: lane l scans j = l, l + L,
//   l + 2L, ... in increasing order with strict compares, so within its
//   lane the first j to attain the minimum keeps it and every other
//   candidate, a later tie included, lowers m2.  Splitting b over lanes
//   multiplies the blocks of a launch when a has few rows.
// - Warp shuffles merge the lanes' (m1, idx, m2): the lower (m1, idx) in
//   lexicographic order wins and the loser's m1 joins the runner-up.  Minima
//   are exact and the merge is a minimum over a set, so for every L and every
//   merge order the result equals the single scan bit for bit.
// - b streams through a ring of shared-memory tiles filled by TMA bulk
//   copies (bulk_ring.cuh).
// - d2 is evaluated with round-to-nearest intrinsics (no FMA contraction),
//   the form the certification band was derived for.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;
constexpr int kStages = 2;
constexpr int kMaxPairs = 8;
constexpr int kNoIndex = 0x7fffffff;  // a lane that saw no point loses every tie

// one pair of a launch; offsets count points of the a and b buffers, and
// rows of the outputs; L = 1 << lane_shift
struct Pair {
  int a_off, n, b_off, m, out_off, lane_shift, item_begin, pad;
};
struct Batch {
  int npairs;
  Pair p[kMaxPairs];
};

template <typename T> struct Traits;
template <> struct Traits<float> {
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float d2(float ax, float ay, float az, const float* q) {
    const float dx = __fsub_rn(ax, q[0]);
    const float dy = __fsub_rn(ay, q[1]);
    const float dz = __fsub_rn(az, q[2]);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
};
template <> struct Traits<double> {
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double d2(double ax, double ay, double az, const double* q) {
    const double dx = __dsub_rn(ax, q[0]);
    const double dy = __dsub_rn(ay, q[1]);
    const double dz = __dsub_rn(az, q[2]);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const T* __restrict__ a, const T* __restrict__ b, const Batch batch,
               T* __restrict__ m1_out, T* __restrict__ m2_out, int64_t* __restrict__ idx_out) {
  using Ring = mmring::PointRing<T, kTile, kStages>;
  __shared__ Ring ring;

  const int tid = threadIdx.x;
  const int item = blockIdx.x;
  int p = 0;
  while (p + 1 < batch.npairs && item >= batch.p[p + 1].item_begin) ++p;
  const Pair P = batch.p[p];
  const int shift = P.lane_shift;
  const int lanes = 1 << shift;
  const int lane = tid & (lanes - 1);
  const int row = ((item - P.item_begin) << (8 - shift)) + (tid >> shift);  // kThreads = 256
  const int ntiles = (P.m + kTile - 1) / kTile;
  const T* pb = b + 3 * static_cast<size_t>(P.b_off);

  if (tid == 0) ring.init();
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < kStages && t < ntiles; ++t) {
      ring.fill(t, pb + 3 * t * kTile, min(kTile, P.m - t * kTile));
    }
  }

  // a row past the end repeats the last row and is never written
  const size_t i = static_cast<size_t>(min(row, P.n - 1)) + P.a_off;
  const T ax = a[3 * i], ay = a[3 * i + 1], az = a[3 * i + 2];
  T m1 = Traits<T>::inf(), m2 = Traits<T>::inf();
  int best = lane < P.m ? lane : kNoIndex;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int j0 = t * kTile;
    const int len = min(kTile, P.m - j0);
    const T* src = pb + 3 * j0;
    ring.wait(s, t / kStages);
    // point jj of b sits at q; both step by the lane count
    const T* q = ring.tile(s, src) + 3 * lane;
    const int step = 3 * lanes;
    const int end = j0 + len;
#pragma unroll 4
    for (int jj = j0 + lane; jj < end; jj += lanes, q += step) {
      const T d = Traits<T>::d2(ax, ay, az, q);
      const bool lower = d < m1;
      m2 = lower ? m1 : (d < m2 ? d : m2);
      best = lower ? jj : best;
      m1 = lower ? d : m1;
    }
    __syncthreads();  // stage s is consumed
    if (tid == 0 && t + kStages < ntiles) {
      const int tn = t + kStages;
      ring.fill(s, pb + 3 * tn * kTile, min(kTile, P.m - tn * kTile));
    }
  }

  // merge the row's lanes (neighbouring threads of one warp)
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const T o1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const T o2 = __shfl_xor_sync(0xffffffffu, m2, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best, off);
    const bool take = o1 < m1 || (o1 == m1 && oi < best);
    const T lost = take ? m1 : o1;
    const T kept2 = take ? o2 : m2;
    m2 = lost < kept2 ? lost : kept2;
    m1 = take ? o1 : m1;
    best = take ? oi : best;
  }
  if (lane == 0 && row < P.n) {
    const size_t o = static_cast<size_t>(P.out_off) + row;
    m1_out[o] = m1;
    m2_out[o] = m2;
    idx_out[o] = best;
  }
}

template <typename T>
int launch(const T* a, const T* b, const int* desc, int npairs, int nitems, T* m1, T* m2,
           int64_t* idx, void* stream) {
  if (npairs < 0 || npairs > kMaxPairs || nitems < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nitems == 0) return 0;
  Batch batch{};
  batch.npairs = npairs;
  for (int p = 0; p < npairs; ++p) {
    const int* d = desc + 8 * p;
    batch.p[p] = Pair{d[0], d[1], d[2], d[3], d[4], d[5], d[6], 0};
    if ((batch.p[p].n > 0 && batch.p[p].m < 1) || batch.p[p].lane_shift < 0 ||
        batch.p[p].lane_shift > 5) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  nearest_kernel<T><<<nitems, kThreads, 0, st>>>(a, b, batch, m1, m2, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mm_nearest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// desc: npairs rows of 8 int32 (a_off, n, b_off, m, out_off, lane_shift,
// item_begin, unused), host memory; m1 / m2 / idx: device outputs, one row
// per row of every pair.
int mm_nearest_f32(const float* a, const float* b, const int* desc, int npairs, int nitems,
                   float* m1, float* m2, int64_t* idx, void* stream) {
  return launch<float>(a, b, desc, npairs, nitems, m1, m2, idx, stream);
}

int mm_nearest_f64(const double* a, const double* b, const int* desc, int npairs, int nitems,
                   double* m1, double* m2, int64_t* idx, void* stream) {
  return launch<double>(a, b, desc, npairs, nitems, m1, m2, idx, stream);
}

}  // extern "C"
