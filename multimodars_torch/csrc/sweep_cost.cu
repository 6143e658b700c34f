// Cost table of the rotation sweep, hand-written for Hopper (sm_90a).
//
// What it computes, for every frame pair f and candidate angle slot k:
//
//   fwd = max over valid test rows i, i = 0, st, 2st, ... of
//           (min over valid ref points j of d2(R(theta_k) t_i, r_j))
//   bwd = max over valid ref rows j, j = 0, sr, 2sr, ... of
//           (min over valid test points i of the same d2)
//   cost[f, k] = max(fwd, bwd); 0 where either whole set of the pair is
//   empty (masked variant); +inf where angles_valid[f, k] is false.
//
// With st = sr = 1 this is the exact squared symmetric Hausdorff table of
// ops/rotation_search.py::rotation_cost_table; with st = sr = 6 it is the
// lower bound of ::_lb_cost_table (outer sets strided, inner sets full).
//
// Replaces the Pallas TPU kernel ops/pallas_kernels.py::_sweep_kernel of the
// JAX package (launched by _sweep_call, wrapped by
// rotation_cost_table_pallas).  That kernel walked a sequential
// (pair, angle block, row chunk) grid and carried its forward/backward
// accumulators in VMEM scratch from one row chunk to the next.  Blocks on
// Hopper run in no order, so nothing is carried between blocks here: one
// block owns one (pair, tile of kAnglesPerBlock angles), holds the pair's
// reference set and its rotated test sets in shared memory, and does both
// passes as loops inside the block.
//
// What bounds it on this card: arithmetic and shared-memory issue, not
// device memory.  A pair's sets are read from device memory once per block
// (about 8 KB in f32 at 520 points), while each angle costs
// (N/st)*M + (M/sr)*N distance evaluations of ~6 instructions, each with
// one broadcast shared-memory load of an (x, y) pair.  The design keeps
// every operand in shared memory or registers, loads (x, y) as one vector,
// spreads the outer rows of all angles of the tile over the block so the
// ragged tail of one angle is filled by the next, and reduces each angle
// with one block-wide max.  Tensor cores, TMA and register tiling of angles
// are left for later work.
//
// d2 is computed in the difference form dx = x*c - y*s - r_x, d2 = dx*dx +
// dy*dy, like the JAX package, and not in the Gram form
// C - 2 (cos A + sin B), which cancels catastrophically and would break the
// argmin-certification band calibrated on the difference form.  nvcc may
// contract these products into FMAs; the resulting f32 divergence is
// measured against the f64 table by chip_smoke.py.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAnglesPerBlock = 4;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

__device__ __forceinline__ float dev_cos(float a) { return cosf(a); }
__device__ __forceinline__ double dev_cos(double a) { return cos(a); }
__device__ __forceinline__ float dev_sin(float a) { return sinf(a); }
__device__ __forceinline__ double dev_sin(double a) { return sin(a); }

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    T other = __shfl_xor_sync(0xffffffffu, v, offset);
    v = other > v ? other : v;
  }
  return v;
}

template <typename T>
size_t smem_bytes(int N, int M, bool masked) {
  using V = typename Vec2<T>::type;
  return (size_t)(M + kAnglesPerBlock * N) * sizeof(V) +
         (masked ? (size_t)(N + M) : 0);
}

// grid (ceil(K / kAnglesPerBlock), F), block kThreads.
// shared memory: ref[M] | rot[kAnglesPerBlock][N] (as (x, y) vectors) |
// test mask[N] | ref mask[M] (masked variant only).
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
sweep_cost_kernel(const T* __restrict__ test, const T* __restrict__ ref,
                  const uint8_t* __restrict__ test_mask,
                  const uint8_t* __restrict__ ref_mask,
                  const T* __restrict__ angles,
                  const uint8_t* __restrict__ angles_valid,
                  T* __restrict__ out, int N, int M, int K, int stride_test,
                  int stride_ref) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* ref_s = reinterpret_cast<V*>(smem_raw);
  V* rot_s = ref_s + M;
  uint8_t* tm_s = reinterpret_cast<uint8_t*>(rot_s + kAnglesPerBlock * N);
  uint8_t* rm_s = tm_s + N;
  __shared__ T red[kAnglesPerBlock][kWarps];

  const int f = blockIdx.y;
  const int k0 = blockIdx.x * kAnglesPerBlock;
  const int tid = threadIdx.x;
  const T inf = pos_inf<T>();

  T cs[kAnglesPerBlock], sn[kAnglesPerBlock];
  bool live[kAnglesPerBlock];
#pragma unroll
  for (int a = 0; a < kAnglesPerBlock; ++a) {
    const int k = k0 + a;
    live[a] = k < K && angles_valid[(size_t)f * K + k] != 0;
    const T theta = live[a] ? angles[(size_t)f * K + k] : T(0);
    cs[a] = dev_cos(theta);
    sn[a] = dev_sin(theta);
  }

  const T* test_f = test + (size_t)f * N * 2;
  const T* ref_f = ref + (size_t)f * M * 2;
  int any_ref = 0, any_test = 0;
  for (int j = tid; j < M; j += kThreads) {
    V r;
    r.x = ref_f[2 * j];
    r.y = ref_f[2 * j + 1];
    ref_s[j] = r;
    if (kMasked) {
      const uint8_t v = ref_mask[(size_t)f * M + j];
      rm_s[j] = v;
      any_ref |= v;
    }
  }
  for (int i = tid; i < N; i += kThreads) {
    const T x = test_f[2 * i];
    const T y = test_f[2 * i + 1];
#pragma unroll
    for (int a = 0; a < kAnglesPerBlock; ++a) {
      V p;
      p.x = x * cs[a] - y * sn[a];
      p.y = x * sn[a] + y * cs[a];
      rot_s[a * N + i] = p;
    }
    if (kMasked) {
      const uint8_t v = test_mask[(size_t)f * N + i];
      tm_s[i] = v;
      any_test |= v;
    }
  }
  bool empty = false;
  if (kMasked) {
    const int t = __syncthreads_or(any_test);
    const int r = __syncthreads_or(any_ref);
    empty = !(t && r);
  } else {
    __syncthreads();
  }

  const int n_out = (N + stride_test - 1) / stride_test;
  const int m_out = (M + stride_ref - 1) / stride_ref;
  const int W = n_out + m_out;  // outer rows of one angle: fwd, then bwd
  T lmax[kAnglesPerBlock];
#pragma unroll
  for (int a = 0; a < kAnglesPerBlock; ++a) {
    lmax[a] = -inf;
    if (empty || !live[a]) continue;
    const V* rot = rot_s + a * N;
    // item g = a * W + w of the tile goes to thread g % kThreads, so the
    // ragged tail of one angle is filled by the start of the next
    const int w0 = ((tid - (a * W) % kThreads) + kThreads) % kThreads;
    T best = -inf;
    for (int w = w0; w < W; w += kThreads) {
      T mn = inf;
      if (w < n_out) {
        const int i = w * stride_test;
        if (kMasked && !tm_s[i]) continue;
        const V p = rot[i];
        for (int j = 0; j < M; ++j) {
          if (kMasked && !rm_s[j]) continue;
          const V q = ref_s[j];
          const T dx = p.x - q.x;
          const T dy = p.y - q.y;
          const T d = dx * dx + dy * dy;
          mn = d < mn ? d : mn;
        }
      } else {
        const int j = (w - n_out) * stride_ref;
        if (kMasked && !rm_s[j]) continue;
        const V q = ref_s[j];
        for (int i = 0; i < N; ++i) {
          if (kMasked && !tm_s[i]) continue;
          const V p = rot[i];
          const T dx = p.x - q.x;
          const T dy = p.y - q.y;
          const T d = dx * dx + dy * dy;
          mn = d < mn ? d : mn;
        }
      }
      best = mn > best ? mn : best;
    }
    lmax[a] = best;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int a = 0; a < kAnglesPerBlock; ++a) {
    const T v = warp_max(lmax[a]);
    if (lane == 0) red[a][warp] = v;
  }
  __syncthreads();
  if (tid < kAnglesPerBlock) {
    const int k = k0 + tid;
    if (k < K) {
      T v = -inf;
      for (int w = 0; w < kWarps; ++w) v = red[tid][w] > v ? red[tid][w] : v;
      T cost;
      if (angles_valid[(size_t)f * K + k] == 0) {
        cost = inf;
      } else if (empty) {
        cost = T(0);
      } else {
        cost = v;
      }
      out[(size_t)f * K + k] = cost;
    }
  }
}

template <typename T>
int launch(const T* test, const T* ref, const uint8_t* test_mask,
           const uint8_t* ref_mask, const T* angles,
           const uint8_t* angles_valid, T* out, int F, int N, int M, int K,
           int stride_test, int stride_ref, int masked, void* stream) {
  const size_t smem = smem_bytes<T>(N, M, masked != 0);
  const dim3 grid((K + kAnglesPerBlock - 1) / kAnglesPerBlock, F);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (masked) {
    err = cudaFuncSetAttribute(sweep_cost_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_cost_kernel<T, true><<<grid, kThreads, smem, s>>>(
        test, ref, test_mask, ref_mask, angles, angles_valid, out, N, M, K,
        stride_test, stride_ref);
  } else {
    err = cudaFuncSetAttribute(sweep_cost_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sweep_cost_kernel<T, false><<<grid, kThreads, smem, s>>>(
        test, ref, nullptr, nullptr, angles, angles_valid, out, N, M, K,
        stride_test, stride_ref);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dynamic shared memory one launch needs, in bytes
long long mm_sweep_smem_bytes(int N, int M, int elem_size, int masked) {
  return (long long)(elem_size == 8 ? smem_bytes<double>(N, M, masked != 0)
                                    : smem_bytes<float>(N, M, masked != 0));
}

// the most dynamic shared memory a block may opt into on ``device``
int mm_sweep_max_smem(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return value;
}

const char* mm_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int mm_sweep_cost_f32(const float* test, const float* ref,
                      const uint8_t* test_mask, const uint8_t* ref_mask,
                      const float* angles, const uint8_t* angles_valid,
                      float* out, int F, int N, int M, int K, int stride_test,
                      int stride_ref, int masked, void* stream) {
  return launch<float>(test, ref, test_mask, ref_mask, angles, angles_valid,
                       out, F, N, M, K, stride_test, stride_ref, masked,
                       stream);
}

int mm_sweep_cost_f64(const double* test, const double* ref,
                      const uint8_t* test_mask, const uint8_t* ref_mask,
                      const double* angles, const uint8_t* angles_valid,
                      double* out, int F, int N, int M, int K, int stride_test,
                      int stride_ref, int masked, void* stream) {
  return launch<double>(test, ref, test_mask, ref_mask, angles, angles_valid,
                        out, F, N, M, K, stride_test, stride_ref, masked,
                        stream);
}

}  // extern "C"
