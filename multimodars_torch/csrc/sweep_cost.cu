// Cost table of the rotation sweep, hand-written for Hopper (sm_90a).
//
// What it computes, for every frame pair f and candidate angle slot k:
//
//   fwd = max over valid test rows i, i = 0, st, 2st, ... of
//           (min over valid ref points j of d2(R(theta_k) t_i, r_j))
//   bwd = max over valid ref rows j, j = 0, sr, 2sr, ... of
//           (min over valid test points i of the same d2)
//   cost[f, k] = max(fwd, bwd); +inf where angles_valid[f, k] is false; else
//   0 where either whole set of the pair is empty (masked variant); -inf
//   where no strided outer row is valid.
//
// The wrapper (ops/sweep.py) fills the output with -inf first.  With
// st = sr = 1 this is the
// exact squared symmetric Hausdorff table of
// ops/rotation_search.py::rotation_cost_table; with st = sr = 6 it is the
// lower bound of ::_lb_cost_table (outer sets strided, inner sets full).
//
// Replaces the Pallas TPU kernel ops/pallas_kernels.py::_sweep_kernel of the
// JAX package (:50; launched by _sweep_call, wrapped by
// rotation_cost_table_pallas).  That kernel walked a sequential
// (pair, angle block, row chunk) grid and carried its accumulators in VMEM
// scratch from one row chunk to the next; here blocks run in no order, and
// partial maxima of blocks meet in the output through atomicMax.
//
// What bounds it on this card: operations.  Each directed point pair costs
// 5 FP operations (dx, dy: 2 subtractions; dy*dy: 1 multiply; dx*dx + that:
// 1 FMA; 1 min), against the 128 FP32 (64 FP64) lanes of each of the 132 SMs
// at up to 1980 MHz: ~6.7e12 pairs/s in f32, ~3.3e12 in f64 (NVIDIA H100
// SXM data sheet).  A pair's sets are a few KB and are read once per block,
// so device memory is no limit.  The first design (one thread per outer row,
// one broadcast shared-memory load, a mask branch and the loop's own compare
// per pair: ~10 issued instructions per pair) ran at 40-51% of that bound on
// the f32 shapes of the main path (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design.  One block owns (pair f, tile of A angles, z-th slice of the
// tile's work items).  It stages the pair's reference set and the test set
// rotated by each of its A angles into shared memory, with every invalid slot
// written as (+inf, +inf) after the rotation: d2 against it is +inf and never
// wins a min, so the inner loops carry no mask branch.  The work items:
//
//   forward item (one test row i): the row rotated by all A angles sits in
//     2A registers; the reference streams past as 16-byte vectors (two f32
//     points or one f64 point), so one load serves 2A (f64: A) pairs;
//   backward item (A reference rows, one angle a): the A rows sit in
//     registers and the test set rotated by a streams past the same way.
//
// Both kinds are the same register-tiled loop of A outer points against an
// inner stream, so forward and backward items mix in a warp without
// divergence.  Where the tile has fewer items than the block has threads
// (the stride-6 lower bound: ~87 rows a side), S adjacent lanes share an
// item, each takes 1/S of the inner stream, and their minima merge with warp
// shuffles.  Where pairs x angle tiles cannot fill the card (the masked
// between tables of 2 pairs, f64 re-searches of a few pairs), the items of a
// tile are split over Z blocks.  Each thread keeps a running max per angle;
// a block reduces them and merges each angle's max into the output with one
// atomicMax on its bit pattern (non-negative IEEE values order like their
// bits as signed integers, and -inf below them).  A block that finds the
// pair empty writes 0, and every block writes +inf at its invalid angles,
// which no other value exceeds; an invalid angle costs no work.  The launch
// planner ops/sweep.py::plan_launch picks
// A, S and Z; it takes a smaller A where the sets would not fit in shared
// memory.
//
// Exactness that the pruning certificate and the f32/f64 certification
// band rely on: every d2 is dx = p.x - q.x (or its exact negation),
// d = fma(dx, dx, dy*dy), and every rotated point is x*c - y*s, x*s + y*c,
// each operation through a round-to-nearest intrinsic, so no contraction by
// the compiler can make the lower-bound and the exact launches, or the
// forward and the backward pass, see different values for the same pair.
// The Gram form C - 2 (cos A + sin B) of the TPU kernel is not used: it
// cancels catastrophically and would break the band calibrated on the
// difference form.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Tr;
template <> struct Tr<float> {
  using V = float2;
  using Bits = int;
  static constexpr int kW = 2;  // points per 16-byte load
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float cos_(float a) { return cosf(a); }
  static __device__ __forceinline__ float sin_(float a) { return sinf(a); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_int(v); }
  static __device__ __forceinline__ void load(const float2* p, float (&x)[kW], float (&y)[kW]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; y[0] = v.y; x[1] = v.z; y[1] = v.w;
  }
};
template <> struct Tr<double> {
  using V = double2;
  using Bits = long long;
  static constexpr int kW = 1;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double cos_(double a) { return cos(a); }
  static __device__ __forceinline__ double sin_(double a) { return sin(a); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
  // a compare and a select: fmin/fmax of doubles issue more on the FP64
  // pipe, which bounds the f64 kernel
  static __device__ __forceinline__ double min_(double a, double b) { return b < a ? b : a; }
  static __device__ __forceinline__ double max_(double a, double b) { return b > a ? b : a; }
  static __device__ __forceinline__ Bits bits(double v) { return __double_as_longlong(v); }
  static __device__ __forceinline__ void load(const double2* p, double (&x)[kW], double (&y)[kW]) {
    const double2 v = *p;
    x[0] = v.x; y[0] = v.y;
  }
};

template <typename T>
__device__ __forceinline__ T d2(T px, T py, T qx, T qy) {
  const T dx = Tr<T>::sub(px, qx);
  const T dy = Tr<T>::sub(py, qy);
  return Tr<T>::fma_(dx, dx, Tr<T>::mul(dy, dy));
}

// grid (ceil(K / A), F, Z), block kThreads.  Shared memory: ref[m_pad] |
// rot[A][n_pad], as (x, y) vectors; m_pad and n_pad are multiples of
// kW << log2_split, so each lane's inner segment starts on a 16-byte
// boundary and holds whole vectors.
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
sweep_cost_kernel(const T* __restrict__ test, const T* __restrict__ ref,
                  const uint8_t* __restrict__ test_mask,
                  const uint8_t* __restrict__ ref_mask,
                  const T* __restrict__ angles,
                  const uint8_t* __restrict__ angles_valid,
                  typename Tr<T>::Bits* __restrict__ out, int N, int M, int K,
                  int stride_test, int stride_ref, int log2_split,
                  int items_per_block, int n_pad, int m_pad) {
  using V = typename Tr<T>::V;
  constexpr int W = Tr<T>::kW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* ref_s = reinterpret_cast<V*>(smem_raw);
  V* rot_s = ref_s + m_pad;
  __shared__ T cs_s[A], sn_s[A];
  __shared__ T red[A][kWarps];
  __shared__ bool valid_s[A];

  const int f = blockIdx.y;
  const int k0 = blockIdx.x * A;
  const int tid = threadIdx.x;
  const T inf = Tr<T>::inf();
  const bool masked = test_mask != nullptr;

  if (tid < A) {
    // a slot past K (the last tile's tail) repeats the last angle; its
    // results are never written
    const int k = min(k0 + tid, K - 1);
    const T theta = angles[(size_t)f * K + k];
    cs_s[tid] = Tr<T>::cos_(theta);
    sn_s[tid] = Tr<T>::sin_(theta);
    valid_s[tid] = k0 + tid < K && angles_valid[(size_t)f * K + k0 + tid] != 0;
  }
  const V* ref_f = reinterpret_cast<const V*>(ref) + (size_t)f * M;
  const V* test_f = reinterpret_cast<const V*>(test) + (size_t)f * N;
  int any_ref = 0;
  for (int j = tid; j < m_pad; j += kThreads) {
    V q;
    q.x = inf;
    q.y = inf;
    if (j < M && (!masked || ref_mask[(size_t)f * M + j] != 0)) {
      q = ref_f[j];
      any_ref = 1;
    }
    ref_s[j] = q;
  }
  __syncthreads();  // the angles' cos, sin and validity
  T cs[A], sn[A];
  bool valid[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    cs[a] = cs_s[a];
    sn[a] = sn_s[a];
    valid[a] = valid_s[a];
  }
  int any_test = 0;
  for (int i = tid; i < n_pad; i += kThreads) {
    const bool ok = i < N && (!masked || test_mask[(size_t)f * N + i] != 0);
    any_test |= ok;
    V p;
    p.x = T(0);
    p.y = T(0);
    if (ok) p = test_f[i];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      V r;
      r.x = inf;
      r.y = inf;
      if (ok) {
        r.x = Tr<T>::sub(Tr<T>::mul(p.x, cs[a]), Tr<T>::mul(p.y, sn[a]));
        r.y = Tr<T>::add(Tr<T>::mul(p.x, sn[a]), Tr<T>::mul(p.y, cs[a]));
      }
      rot_s[a * n_pad + i] = r;
    }
  }
  const int t_any = __syncthreads_or(any_test);
  const int r_any = __syncthreads_or(any_ref);
  if (!(t_any && r_any)) {  // the same in every thread of the block
    if (tid < A && k0 + tid < K)
      atomicMax(out + (size_t)f * K + k0 + tid,
                Tr<T>::bits(valid_s[tid] ? T(0) : inf));
    return;
  }

  const int n_out = (N + stride_test - 1) / stride_test;
  const int m_out = (M + stride_ref - 1) / stride_ref;
  const int groups = (m_out + A - 1) / A;  // backward items per angle
  const int items = n_out + A * groups;
  const int q0 = blockIdx.z * items_per_block;
  const int q1 = min(items, q0 + items_per_block);
  const int tasks = max(0, q1 - q0) << log2_split;
  const int S = 1 << log2_split;
  const int seg = tid & (S - 1);
  const int lane = tid & 31;
  // the S lanes of one item: adjacent, aligned, in one warp; they run the
  // same number of rounds, since kThreads and tasks are multiples of S
  const unsigned group_mask =
      S == 32 ? 0xffffffffu : (((1u << S) - 1u) << (lane & ~(S - 1)));
  const int seg_m = m_pad >> log2_split;
  const int seg_n = n_pad >> log2_split;

  T acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) acc[a] = -inf;

  for (int t = tid; t < tasks; t += kThreads) {
    const int q = q0 + (t >> log2_split);
    T ox[A], oy[A];
    bool ok[A];
    bool any = false;
    const V* inner;
    int len;
    int a_bwd;  // the angle of a backward item; -1 for a forward item
    if (q < n_out) {
      const int i = q * stride_test;
      const bool row_ok = rot_s[i].x != inf;  // a masked slot is a sentinel
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const V p = rot_s[a * n_pad + i];
        ox[a] = p.x;
        oy[a] = p.y;
        ok[a] = row_ok && valid[a];
        any |= ok[a];
      }
      inner = ref_s + seg * seg_m;
      len = seg_m;
      a_bwd = -1;
    } else {
      const int b = q - n_out;
      a_bwd = b / groups;
      const int g = b - a_bwd * groups;
      // a dynamic index would put valid[] in local memory
      bool live = false;
#pragma unroll
      for (int a = 0; a < A; ++a) live |= a == a_bwd && valid[a];
#pragma unroll
      for (int r = 0; r < A; ++r) {
        const int jr = g * A + r;
        const bool in = jr < m_out;
        const V v = ref_s[in ? jr * stride_ref : 0];
        ox[r] = v.x;
        oy[r] = v.y;
        ok[r] = live && in && v.x != inf;
        any |= ok[r];
      }
      inner = rot_s + a_bwd * n_pad + seg * seg_n;
      len = seg_n;
    }
    if (!any) len = 0;  // the same for the S lanes of the item

    T mn[A];
#pragma unroll
    for (int r = 0; r < A; ++r) mn[r] = inf;
#pragma unroll 2
    for (int j = 0; j < len; j += W) {
      T qx[W], qy[W];
      Tr<T>::load(inner + j, qx, qy);
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int r = 0; r < A; ++r)
          mn[r] = Tr<T>::min_(mn[r], d2<T>(ox[r], oy[r], qx[w], qy[w]));
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < A; ++r)
        mn[r] = Tr<T>::min_(mn[r], __shfl_xor_sync(group_mask, mn[r], off));
    }
    // every lane of the item holds the merged minima; max is idempotent
    if (a_bwd < 0) {
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (ok[a]) acc[a] = Tr<T>::max_(acc[a], mn[a]);
    } else {
      T v = -inf;
#pragma unroll
      for (int r = 0; r < A; ++r)
        if (ok[r]) v = Tr<T>::max_(v, mn[r]);
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (a == a_bwd) acc[a] = Tr<T>::max_(acc[a], v);
    }
  }

  const int warp = tid >> 5;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    T v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = Tr<T>::max_(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[a][warp] = v;
  }
  __syncthreads();
  if (tid < A && k0 + tid < K) {
    T v = red[tid][0];
    for (int w = 1; w < kWarps; ++w) v = Tr<T>::max_(v, red[tid][w]);
    if (!valid_s[tid]) v = inf;
    if (v != -inf) atomicMax(out + (size_t)f * K + k0 + tid, Tr<T>::bits(v));
  }
}

template <typename T, int A>
int launch_tile(const T* test, const T* ref, const uint8_t* test_mask,
                const uint8_t* ref_mask, const T* angles,
                const uint8_t* angles_valid, void* out, int F,
                int N, int M, int K, int stride_test, int stride_ref,
                int log2_split, int block_split, int items_per_block,
                int n_pad, int m_pad, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_cost_kernel<T, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + A - 1) / A, F, block_split);
  sweep_cost_kernel<T, A><<<grid, kThreads, smem, stream>>>(
      test, ref, test_mask, ref_mask, angles, angles_valid,
      reinterpret_cast<typename Tr<T>::Bits*>(out), N, M, K, stride_test,
      stride_ref, log2_split, items_per_block, n_pad, m_pad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* test, const T* ref, const uint8_t* test_mask,
           const uint8_t* ref_mask, const T* angles,
           const uint8_t* angles_valid, void* out, int F, int N,
           int M, int K, int stride_test, int stride_ref, int angle_tile,
           int log2_split, int block_split, int items_per_block, int n_pad,
           int m_pad, int smem, void* stream) {
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MM_SWEEP_TILE(A)                                                      \
  case A:                                                                     \
    return launch_tile<T, A>(test, ref, test_mask, ref_mask, angles,         \
                             angles_valid, out, F, N, M, K, stride_test,      \
                             stride_ref, log2_split,                          \
                             block_split, items_per_block, n_pad, m_pad,      \
                             smem, s);
  // the tiles ops/sweep.py::ANGLE_TILES names for the element size
  if constexpr (sizeof(T) == 4) {
    switch (angle_tile) {
      MM_SWEEP_TILE(8)
      MM_SWEEP_TILE(4)
      default:
        break;
    }
  }
  switch (angle_tile) {
    MM_SWEEP_TILE(2)
    MM_SWEEP_TILE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MM_SWEEP_TILE
}

}  // namespace

extern "C" {

const char* mm_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out: F x K words of the element's width, filled with -inf beforehand
// (test_mask and ref_mask null: dense); the launch parameters come from
// ops/sweep.py::plan_launch; returns the launch's CUDA error code
int mm_sweep_cost_f32(const float* test, const float* ref,
                      const uint8_t* test_mask, const uint8_t* ref_mask,
                      const float* angles, const uint8_t* angles_valid,
                      void* out, int F, int N, int M,
                      int K, int stride_test, int stride_ref, int angle_tile,
                      int log2_split, int block_split, int items_per_block,
                      int n_pad, int m_pad, int smem, void* stream) {
  return launch<float>(test, ref, test_mask, ref_mask, angles, angles_valid,
                       out, F, N, M,
                       K, stride_test, stride_ref, angle_tile, log2_split,
                       block_split, items_per_block, n_pad, m_pad, smem,
                       stream);
}

int mm_sweep_cost_f64(const double* test, const double* ref,
                      const uint8_t* test_mask, const uint8_t* ref_mask,
                      const double* angles, const uint8_t* angles_valid,
                      void* out, int F, int N, int M,
                      int K, int stride_test, int stride_ref, int angle_tile,
                      int log2_split, int block_split, int items_per_block,
                      int n_pad, int m_pad, int smem, void* stream) {
  return launch<double>(test, ref, test_mask, ref_mask, angles, angles_valid,
                        out, F, N, M,
                        K, stride_test, stride_ref, angle_tile, log2_split,
                        block_split, items_per_block, n_pad, m_pad, smem,
                        stream);
}

}  // extern "C"
