// Cost table of the centerline-morph sweep, hand-written for Hopper (sm_90a).
//
// What it computes, for every offset k of xs [K], with moved points
// p_i(k) = points[i] + unit[i] * xs[k] (points, unit [N, 3]) against the
// reference set r_j (reference [M, 3], N, M >= 1):
//
//   d2(i, j, k) = ((px - rx)^2 + (py - ry)^2) + (pz - rz)^2
//   fwd[k] = sum_i min_j d2(i, j, k)      (moved -> reference)
//   bwd[k] = sum_j min_i d2(i, j, k)      (reference -> moved)
//
// The host takes cost[k] = sqrt((fwd[k] / N + bwd[k] / M) / 2).  This is
// _sweep_cost_table of the JAX package (ccta/kernels.py:2183,
// the grid sweep of scale_coronary.rs:65-130); its row masks existed for
// padded jit shapes, and the port passes the sets at their size.  The
// wrapper keeps _sweep_finish's certification: every offset whose cost lies
// within 2 cmin 1e-4 + 1e-12 of the minimum is re-evaluated exactly in
// float64 on the host.
//
// Design.  Both directions come from the same d2, in one pass per (offset,
// tile of rows).  Kernel 1: one block owns offset k and kRowsPerBlock moved
// rows (kRowsPerThread per thread in registers with their running minima;
// a row past the end sits at +inf, so its d2 is +inf and it moves no
// minimum).  The block streams the reference through shared memory in tiles
// of kTile points.  For each reference point, every thread folds its rows'
// d2 into the row minima and into one local minimum, the warp reduces those
// (__reduce_min_sync on the bits of non-negative floats, which order like
// the floats; shuffles in float64), and one lane per warp lowers the point's
// slot in a shared column-minimum tile with atomicMin.  At the end of each
// tile the block lowers the global column minima [K, M] with one atomicMin
// per point, and at the end of the stream it writes the sum of its rows'
// minima to a partial slot [K, row tiles].  Kernel 2: one block per offset
// sums its partials and its column minima.  Every sum runs in a fixed order
// (a thread's strided share, a warp butterfly, the warps in turn), so the
// result is the same from run to run; minima are exact, so only the
// summation order differs from the plain version (float64 within rel 1e-12).
// d2 and the moved point are evaluated with round-to-nearest intrinsics (no
// FMA contraction), as the plain version rounds them.
//
// What bounds it on this card: FP32 (FP64) instruction throughput.  Each (offset, row,
// reference point) costs the d2 (3 sub, 3 mul, 2 add) and two minima; the
// warp reduction and the shared atomic are shared by the warp's rows.  The
// main path's sweeps are small (a few hundred to a few thousand points a
// side, 41 offsets), so launch latency weighs as much as the pipe.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTile = 1024;
constexpr int kSumThreads = 256;

struct alignas(16) F4 { float x, y, z, w; };
struct alignas(32) D4 { double x, y, z, w; };

template <typename T> struct Traits;
template <> struct Traits<float> {
  using Vec = F4;
  using Bits = unsigned int;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float d2(float ax, float ay, float az, F4 b) {
    const float dx = __fsub_rn(ax, b.x);
    const float dy = __fsub_rn(ay, b.y);
    const float dz = __fsub_rn(az, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  static __device__ __forceinline__ float moved(float p, float u, float x) {
    return __fadd_rn(p, __fmul_rn(u, x));
  }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float value(Bits v) { return __uint_as_float(v); }
  static __device__ __forceinline__ Bits warp_min_bits(float v) {
    return __reduce_min_sync(0xffffffffu, __float_as_uint(v));
  }
};
template <> struct Traits<double> {
  using Vec = D4;
  using Bits = unsigned long long;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double d2(double ax, double ay, double az, D4 b) {
    const double dx = __dsub_rn(ax, b.x);
    const double dy = __dsub_rn(ay, b.y);
    const double dz = __dsub_rn(az, b.z);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
  }
  static __device__ __forceinline__ double moved(double p, double u, double x) {
    return __dadd_rn(p, __dmul_rn(u, x));
  }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ Bits bits(double v) {
    return (unsigned long long)__double_as_longlong(v);
  }
  static __device__ __forceinline__ double value(Bits v) {
    return __longlong_as_double((long long)v);
  }
  static __device__ __forceinline__ Bits warp_min_bits(double v) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const double other = __shfl_xor_sync(0xffffffffu, v, offset);
      v = other < v ? other : v;
    }
    return bits(v);
  }
};

// the sum of one value per thread of the block, in a fixed order: a warp
// butterfly, then the warps in turn; the total is valid in thread 0
template <typename T, int kBlock>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = Traits<T>::add(v, __shfl_xor_sync(0xffffffffu, v, offset));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = red[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kBlock / 32; ++w) total = Traits<T>::add(total, red[w]);
  return total;
}

// grid (row tiles, K), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
morph_sweep_kernel(const T* __restrict__ points, const T* __restrict__ unit,
                   const T* __restrict__ ref, const T* __restrict__ xs, int n, int m,
                   typename Traits<T>::Bits* __restrict__ col_min,
                   T* __restrict__ partial) {
  using V = typename Traits<T>::Vec;
  using Bits = typename Traits<T>::Bits;
  __shared__ V tile[kTile];
  __shared__ Bits tile_min[kTile];
  __shared__ T red[kWarps];

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const T x = xs[k];
  const T inf = Traits<T>::inf();
  const Bits inf_bits = Traits<T>::bits(inf);
  T px[kRowsPerThread], py[kRowsPerThread], pz[kRowsPerThread], mn[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = blockIdx.x * kRowsPerBlock + r * kThreads + tid;
    const size_t o = 3 * (size_t)i;
    const bool live = i < n;
    px[r] = live ? Traits<T>::moved(points[o], unit[o], x) : inf;
    py[r] = live ? Traits<T>::moved(points[o + 1], unit[o + 1], x) : inf;
    pz[r] = live ? Traits<T>::moved(points[o + 2], unit[o + 2], x) : inf;
    mn[r] = inf;
  }

  Bits* col = col_min + (size_t)k * m;
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();  // the previous tile and its minima are consumed
    for (int j = tid; j < len; j += kThreads) {
      const size_t o = 3 * (size_t)(j0 + j);
      tile[j] = V{ref[o], ref[o + 1], ref[o + 2], T(0)};
      tile_min[j] = inf_bits;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < len; ++j) {
      const V q = tile[j];
      T local = inf;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const T d = Traits<T>::d2(px[r], py[r], pz[r], q);
        mn[r] = d < mn[r] ? d : mn[r];
        local = d < local ? d : local;
      }
      const Bits w = Traits<T>::warp_min_bits(local);
      if ((tid & 31) == 0) atomicMin(tile_min + j, w);
    }
    __syncthreads();
    for (int j = tid; j < len; j += kThreads)
      if (tile_min[j] != inf_bits) atomicMin(col + j0 + j, tile_min[j]);
  }

  T s = T(0);
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    if (blockIdx.x * kRowsPerBlock + r * kThreads + tid < n) s = Traits<T>::add(s, mn[r]);
  const T total = block_sum<T, kThreads>(s, red);
  if (tid == 0) partial[(size_t)k * gridDim.x + blockIdx.x] = total;
}

// grid K, block kSumThreads
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
morph_sweep_sum_kernel(const T* __restrict__ partial, int tiles,
                       const typename Traits<T>::Bits* __restrict__ col_min, int m,
                       T* __restrict__ fwd, T* __restrict__ bwd) {
  __shared__ T red[kSumThreads / 32];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  T s = T(0);
  for (int t = tid; t < tiles; t += kSumThreads)
    s = Traits<T>::add(s, partial[(size_t)k * tiles + t]);
  const T f = block_sum<T, kSumThreads>(s, red);
  if (tid == 0) fwd[k] = f;
  __syncthreads();  // red is reused
  s = T(0);
  for (int j = tid; j < m; j += kSumThreads)
    s = Traits<T>::add(s, Traits<T>::value(col_min[(size_t)k * m + j]));
  const T b = block_sum<T, kSumThreads>(s, red);
  if (tid == 0) bwd[k] = b;
}

template <typename T>
int launch(const T* points, const T* unit, const T* ref, const T* xs, int n, int m,
           int K, void* col_min, T* partial, T* fwd, T* bwd, void* stream) {
  if (K == 0) return 0;
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  using Bits = typename Traits<T>::Bits;
  const int tiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  morph_sweep_kernel<T><<<dim3(tiles, K), kThreads, 0, st>>>(
      points, unit, ref, xs, n, m, reinterpret_cast<Bits*>(col_min), partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  morph_sweep_sum_kernel<T><<<K, kSumThreads, 0, st>>>(
      partial, tiles, reinterpret_cast<const Bits*>(col_min), m, fwd, bwd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mm_morph_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// col_min: K * m words holding +inf; partial: K * ceil(n / 512) slots
int mm_morph_sweep_f32(const float* points, const float* unit, const float* ref,
                       const float* xs, int n, int m, int K, void* col_min,
                       float* partial, float* fwd, float* bwd, void* stream) {
  return launch<float>(points, unit, ref, xs, n, m, K, col_min, partial, fwd, bwd, stream);
}

int mm_morph_sweep_f64(const double* points, const double* unit, const double* ref,
                       const double* xs, int n, int m, int K, void* col_min,
                       double* partial, double* fwd, double* bwd, void* stream) {
  return launch<double>(points, unit, ref, xs, n, m, K, col_min, partial, fwd, bwd, stream);
}

}  // extern "C"
