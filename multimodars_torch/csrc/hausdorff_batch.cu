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
// evaluates [S*K, n, m] as one XLA program, and the public
// ops.hausdorff_sq_masked on a CUDA tensor.  It is not a Pallas kernel; on
// this card it needs one because its sets are far larger than the sweep
// kernel's (csrc/sweep_cost.cu keeps both sets whole in shared memory): a
// tube cloud around a 56 mm coronary segment keeps ~7k-16k points after the
// bounding-box filter, and the candidates are as many, so one call holds
// ~2e10 pairs and the plain version's [S*K, n, m] tile would not fit.
//
// What bounds it on this card: operations.  The function's least work is
// each valid (p, q) pair once: d2 (2 subtractions, 2 multiplies, 1 add,
// left unfused) and one min for its row and one for its column, 7
// operations, against the 128 FP32 (64 FP64) lanes of each of the 132 SMs.
// The sets are a few hundred KB and are read from L2, so device memory is
// no limit.
//
// Design.  Each d2 is evaluated once and serves both directions.  A block
// owns (candidate c, a tile of row groups of the row set, a split of column
// chunks of the other set); which set takes the row side is the planner's
// choice (ops/hausdorff_batch.py::plan_launch), since d2 has the same bits
// either way (dx only changes sign).
//
//   rows: a warp owns one group of 32 R rows, R in registers a lane, with
//     their running minima, which are complete once the block has streamed
//     its split;
//   columns: the split streams through shared memory in chunks of 32 units
//     (a unit is one 16-byte load: two f32 points or one f64 point), each
//     chunk stored twice in a row, so lane l reads unit (l + t) mod 32 at
//     step t from address l + t with no index arithmetic.  A lane keeps the
//     running minimum of the unit it holds over its R rows and, after each
//     step, takes the minimum of the unit it reads next from the lane
//     above: after 32 steps every unit's minimum has visited the 32 lanes,
//     one shuffle a column a lane (not the 10 of a butterfly per column).
//     The warps of the block merge their minima per column with a shared
//     atomicMin, one per column a warp and chunk.
//
// Invalid rows hold (+inf, +inf) and invalid columns (-inf, -inf): d2 of
// any pair with an invalid point is +inf (never inf - inf, which is NaN),
// so the inner loop carries no mask, and no invalid point wins a minimum;
// maxima read only valid points' minima.  Minima and maxima of non-negative
// values merge as the bits of unsigned words (atomicMin / atomicMax).
//
// Where the row set has one tile, a block's column minima are complete and
// it takes their maximum itself; else it merges them into a [C, cols]
// scratch.  Where the columns have one split, its row minima are complete;
// else they meet in a [C, rows] scratch.  Complete maxima merge into a [C]
// word.  Each block then ORs whether its rows and its columns held a valid
// point into the candidate's flags and takes a ticket; the candidate's last
// block reduces the scratch over the valid points, writes out[c] (0 unless
// both flags are set), and resets the scratch, the word, the flags and the
// ticket to their initial state for the next launch: one launch a call, and
// no fill of the scratch.
//
// d2 = (px - qx)^2 + (py - qy)^2 is evaluated with the round-to-nearest
// intrinsics (__fsub_rn/__fmul_rn/__fadd_rn, __dsub_rn/__dmul_rn/__dadd_rn),
// which nvcc never contracts into an FMA: every f64 d2 equals numpy's
// dx*dx + dy*dy bit for bit, min and max are exact, so the f64 table equals
// the host's exact f64 table, and the f32 table equals the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kChunk = 32;       // units a chunk: one a lane
constexpr int kTileChunks = 16;  // chunks staged in shared memory at once

template <typename T> struct Tr;
template <> struct Tr<float> {
  using V = float4;  // one unit: two points
  using Bits = unsigned int;
  static constexpr int kU = 2;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float val(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ void split(const V& v, float (&x)[kU], float (&y)[kU]) {
    x[0] = v.x; y[0] = v.y; x[1] = v.z; y[1] = v.w;
  }
  static __device__ __forceinline__ V join(const float (&x)[kU], const float (&y)[kU]) {
    return make_float4(x[0], y[0], x[1], y[1]);
  }
};
template <> struct Tr<double> {
  using V = double2;  // one unit: one point
  using Bits = unsigned long long;
  static constexpr int kU = 1;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  // a compare and a select: fmin/fmax of doubles issue more on the FP64
  // pipe, which bounds the f64 kernel
  static __device__ __forceinline__ double min_(double a, double b) { return b < a ? b : a; }
  static __device__ __forceinline__ double max_(double a, double b) { return b > a ? b : a; }
  static __device__ __forceinline__ Bits bits(double v) {
    return static_cast<Bits>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double val(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ __forceinline__ void split(const V& v, double (&x)[kU], double (&y)[kU]) {
    x[0] = v.x; y[0] = v.y;
  }
  static __device__ __forceinline__ V join(const double (&x)[kU], const double (&y)[kU]) {
    return make_double2(x[0], y[0]);
  }
};

template <typename T>
__device__ __forceinline__ T d2(T px, T py, T qx, T qy) {
  const T dx = Tr<T>::sub(px, qx);
  const T dy = Tr<T>::sub(py, qy);
  return Tr<T>::add(Tr<T>::mul(dx, dx), Tr<T>::mul(dy, dy));
}

template <typename T> struct Params {
  const T* p;                  // [C, n, 2]
  const uint8_t* pm;           // [C, n]
  const T* q;                  // [S, m, 2]
  const uint8_t* qm;           // [S, m]
  T* out;                      // [C]
  typename Tr<T>::Bits* best;  // [C], 0 bits; left so
  unsigned int* state;         // [C][2]: ticket, flags; 0; left so
  typename Tr<T>::Bits* row_part;  // [C, rows] +inf bits when splits > 1; left so
  typename Tr<T>::Bits* col_part;  // [C, cols] +inf bits when tiles > 1; left so
  int C, n, m, K, swap, tiles, splits, chunks_per_split;
  long long groups;            // row groups of 32 R rows
};

template <typename T>
__device__ __forceinline__ T block_max(T v, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = Tr<T>::max_(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may hold an earlier reduction's values
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = Tr<T>::max_(v, red[w]);
  return v;
}

// grid (C * tiles * splits), block 32 * warps (warps <= kMaxWarps): block b
// is candidate b % C, row tile (b / C) % tiles, column split b / (C * tiles).
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
hausdorff_batch_kernel(const Params<T> a) {
  using Tt = Tr<T>;
  using V = typename Tt::V;
  using Bits = typename Tt::Bits;
  constexpr int U = Tt::kU;
  constexpr int kTileCols = kTileChunks * kChunk * U;
  __shared__ V stage[kTileChunks][2 * kChunk];
  __shared__ Bits colmin_s[kTileCols];
  __shared__ T red[kMaxWarps];
  __shared__ unsigned int last_s;

  const T inf = Tt::inf();
  const Bits inf_bits = Tt::bits(inf);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const int c = static_cast<int>(b % a.C);
  const long long rest = b / a.C;
  const int tile = static_cast<int>(rest % a.tiles);
  const int split = static_cast<int>(rest / a.tiles);
  const int s = c / a.K;

  const T* p_c = a.p + static_cast<size_t>(c) * a.n * 2;
  const uint8_t* pm_c = a.pm + static_cast<size_t>(c) * a.n;
  const T* q_s = a.q + static_cast<size_t>(s) * a.m * 2;
  const uint8_t* qm_s = a.qm + static_cast<size_t>(s) * a.m;
  const T* rows = a.swap ? q_s : p_c;
  const uint8_t* rmask = a.swap ? qm_s : pm_c;
  const long long n_rows = a.swap ? a.m : a.n;
  const T* cols = a.swap ? p_c : q_s;
  const uint8_t* cmask = a.swap ? pm_c : qm_s;
  const long long n_cols = a.swap ? a.n : a.m;

  // this tile's row groups [g0, g1): balanced, one warp each
  const long long g0 = tile * a.groups / a.tiles;
  const long long g1 = (tile + 1) * a.groups / a.tiles;
  const bool active = warp < g1 - g0;
  const long long row0 = (g0 + warp) * (32LL * R) + lane;
  T px[R], py[R], rmin[R];
  bool live[R];
  int any_row = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = row0 + 32LL * r;
    live[r] = active && i < n_rows && rmask[i] != 0;
    px[r] = inf;
    py[r] = inf;
    if (live[r]) {
      px[r] = rows[2 * i];
      py[r] = rows[2 * i + 1];
    }
    rmin[r] = inf;
    any_row |= live[r];
  }
  any_row = __syncthreads_or(any_row);

  // this split's column chunks [ch_begin, ch_end)
  const long long n_chunks = (n_cols + kChunk * U - 1) / (kChunk * U);
  const long long ch_begin = static_cast<long long>(split) * a.chunks_per_split;
  const long long ch_end = min(n_chunks, ch_begin + a.chunks_per_split);
  T colmax = T(0);
  int any_col = 0;
  for (long long ch0 = ch_begin; ch0 < ch_end; ch0 += kTileChunks) {
    const int nch = static_cast<int>(min(static_cast<long long>(kTileChunks), ch_end - ch0));
    __syncthreads();  // the previous tile is consumed and flushed
    int any = 0;
    for (int k = tid; k < nch * kChunk; k += blockDim.x) {
      T x[U], y[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long j = (ch0 * kChunk + k) * U + u;
        const bool ok = j < n_cols && cmask[j] != 0;
        x[u] = -inf;
        y[u] = -inf;
        if (ok) {
          x[u] = cols[2 * j];
          y[u] = cols[2 * j + 1];
        }
        any |= ok;
      }
      const V v = Tt::join(x, y);
      stage[k / kChunk][k % kChunk] = v;
      stage[k / kChunk][k % kChunk + kChunk] = v;
    }
    for (int k = tid; k < nch * kChunk * U; k += blockDim.x) colmin_s[k] = inf_bits;
    any_col |= __syncthreads_or(any);
    if (active) {
      for (int ch = 0; ch < nch; ++ch) {
        const V* src = &stage[ch][lane];
        T cm[U];
#pragma unroll
        for (int u = 0; u < U; ++u) cm[u] = inf;
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t) {
          T qx[U], qy[U];
          Tt::split(src[t], qx, qy);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            T lo = inf;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const T d = d2<T>(px[r], py[r], qx[u], qy[u]);
              rmin[r] = Tt::min_(rmin[r], d);
              lo = r == 0 ? d : Tt::min_(lo, d);
            }
            // the unit read at step t is (lane + t) mod 32; the next step's
            // minimum so far sits in the lane above
            cm[u] = __shfl_sync(0xffffffffu, Tt::min_(cm[u], lo), (lane + 1) & 31);
          }
        }
        // after 32 steps and shuffles the lane holds unit `lane`'s minimum
#pragma unroll
        for (int u = 0; u < U; ++u) atomicMin(&colmin_s[(ch * kChunk + lane) * U + u], Tt::bits(cm[u]));
      }
    }
    __syncthreads();
    for (int k = tid; k < nch * kChunk * U; k += blockDim.x) {
      const long long j = ch0 * kChunk * U + k;
      if (j >= n_cols || cmask[j] == 0) continue;
      const Bits v = colmin_s[k];
      if (a.tiles == 1) {
        colmax = Tt::max_(colmax, Tt::val(v));  // complete: every row is in this block
      } else if (v != inf_bits) {
        atomicMin(&a.col_part[static_cast<size_t>(c) * n_cols + j], v);
      }
    }
  }

  T mine = colmax;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live[r]) continue;
    if (a.splits == 1) {
      mine = Tt::max_(mine, rmin[r]);  // complete: every column streamed past
    } else if (rmin[r] != inf) {
      atomicMin(&a.row_part[static_cast<size_t>(c) * n_rows + row0 + 32LL * r], Tt::bits(rmin[r]));
    }
  }
  mine = block_max(mine, red);
  unsigned int* state = a.state + 2 * static_cast<size_t>(c);
  if (tid == 0) {
    if (mine > T(0)) atomicMax(&a.best[c], Tt::bits(mine));
    const unsigned int flags = (any_row ? 1u : 0u) | (any_col ? 2u : 0u);
    if (flags) atomicOr(&state[1], flags);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_s = atomicAdd(&state[0], 1u) == static_cast<unsigned int>(a.tiles * a.splits - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the candidate's last block: its partial minima, then out[c]
  T fin = T(0);
  if (a.tiles > 1) {
    Bits* part = a.col_part + static_cast<size_t>(c) * n_cols;
    for (long long j = tid; j < n_cols; j += blockDim.x) {
      const Bits v = __ldcg(part + j);
      if (v == inf_bits) continue;  // never written
      part[j] = inf_bits;
      if (cmask[j] != 0) fin = Tt::max_(fin, Tt::val(v));
    }
  }
  if (a.splits > 1) {
    Bits* part = a.row_part + static_cast<size_t>(c) * n_rows;
    for (long long i = tid; i < n_rows; i += blockDim.x) {
      const Bits v = __ldcg(part + i);
      if (v == inf_bits) continue;
      part[i] = inf_bits;
      if (rmask[i] != 0) fin = Tt::max_(fin, Tt::val(v));
    }
  }
  fin = block_max(fin, red);
  if (tid == 0) {
    fin = Tt::max_(fin, Tt::val(atomicExch(&a.best[c], Bits(0))));
    const unsigned int flags = atomicExch(&state[1], 0u);
    a.out[c] = flags == 3u ? fin : T(0);
    state[0] = 0u;
  }
}

template <typename T, int R>
int launch_r(const Params<T>& a, int warps, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(a.C) * a.tiles * a.splits;
  hausdorff_batch_kernel<T, R><<<static_cast<unsigned int>(blocks), 32 * warps, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the rows a thread holds: the variants ops/hausdorff_batch.py::ROWS_PER_THREAD
// names for the element size
template <typename T>
int launch(Params<T> a, int R, int warps, void* stream) {
  const long long n_rows = a.swap ? a.m : a.n;
  const long long n_cols = a.swap ? a.n : a.m;
  const long long n_chunks = (n_cols + kChunk * Tr<T>::kU - 1) / (kChunk * Tr<T>::kU);
  if (a.C < 1 || a.n < 1 || a.m < 1 || a.K < 1 || a.C % a.K != 0 || warps < 1 ||
      warps > kMaxWarps || a.tiles < 1 || a.splits < 1 || a.chunks_per_split < 1 ||
      a.groups != (n_rows + 32LL * R - 1) / (32LL * R) || a.tiles > a.groups ||
      (a.groups + a.tiles - 1) / a.tiles > warps ||
      static_cast<long long>(a.splits) * a.chunks_per_split < n_chunks ||
      static_cast<long long>(a.C) * a.tiles * a.splits > 0x7fffffffLL ||
      (a.tiles > 1 && a.col_part == nullptr) || (a.splits > 1 && a.row_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    switch (R) {
      case 2: return launch_r<T, 2>(a, warps, st);
      case 4: return launch_r<T, 4>(a, warps, st);
      case 8: return launch_r<T, 8>(a, warps, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (R) {
      case 1: return launch_r<T, 1>(a, warps, st);
      case 2: return launch_r<T, 2>(a, warps, st);
      case 4: return launch_r<T, 4>(a, warps, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

template <typename T, int R>
int info_r(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, hausdorff_batch_kernel<T, R>);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  for (int w = 1; w <= kMaxWarps; ++w) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, hausdorff_batch_kernel<T, R>,
                                                        32 * w, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[2 + w] = blocks;
  }
  info[3 + kMaxWarps] = kChunk;
  info[4 + kMaxWarps] = kTileChunks;
  return 0;
}

template <typename T>
Params<T> params(const T* p, const uint8_t* pm, const T* q, const uint8_t* qm, T* out,
                 void* best, unsigned int* state, void* row_part, void* col_part, int C,
                 int n, int m, int K, int swap, int R, int tiles, int splits,
                 int chunks_per_split) {
  using Bits = typename Tr<T>::Bits;
  Params<T> a;
  a.p = p; a.pm = pm; a.q = q; a.qm = qm; a.out = out;
  a.best = static_cast<Bits*>(best);
  a.state = state;
  a.row_part = static_cast<Bits*>(row_part);
  a.col_part = static_cast<Bits*>(col_part);
  a.C = C; a.n = n; a.m = m; a.K = K; a.swap = swap != 0;
  a.tiles = tiles; a.splits = splits; a.chunks_per_split = chunks_per_split;
  const long long n_rows = swap ? m : n;
  a.groups = (n_rows + 32LL * R - 1) / (32LL * R);
  return a;
}

}  // namespace

extern "C" {

const char* mm_hausdorff_batch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// info[0 .. 4 + 16]: registers a thread, local (spilled) bytes a thread,
// static shared bytes a block, resident blocks per SM at 1 .. 16 warps a
// block, units a chunk, chunks a shared-memory tile; for the variant of
// `elem_size` (4 or 8) and `R` rows a thread.  Returns 0 or a CUDA error.
int mm_hausdorff_batch_info(int elem_size, int R, int* info) {
  if (elem_size == 4) {
    switch (R) {
      case 2: return info_r<float, 2>(info);
      case 4: return info_r<float, 4>(info);
      case 8: return info_r<float, 8>(info);
    }
  } else if (elem_size == 8) {
    switch (R) {
      case 1: return info_r<double, 1>(info);
      case 2: return info_r<double, 2>(info);
      case 4: return info_r<double, 4>(info);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// p [C, n, 2], pm [C, n], q [S, m, 2], qm [S, m] (C = S * K), out [C]; best:
// C words of the element's width, 0; state: 2 C words, 0; row_part: C x
// (m if swap else n) words of +inf bits, or null when splits = 1; col_part:
// C x (n if swap else m) words of +inf bits, or null when tiles = 1.  The
// kernel leaves the scratch as it found it.  R, warps, tiles, splits and
// chunks_per_split come from ops/hausdorff_batch.py::plan_launch.
int mm_hausdorff_batch_f32(const float* p, const uint8_t* pm, const float* q,
                           const uint8_t* qm, float* out, void* best, unsigned int* state,
                           void* row_part, void* col_part, int C, int n, int m, int K,
                           int swap, int R, int warps, int tiles, int splits,
                           int chunks_per_split, void* stream) {
  return launch<float>(params<float>(p, pm, q, qm, out, best, state, row_part, col_part, C, n,
                                     m, K, swap, R, tiles, splits, chunks_per_split),
                       R, warps, stream);
}

int mm_hausdorff_batch_f64(const double* p, const uint8_t* pm, const double* q,
                           const uint8_t* qm, double* out, void* best, unsigned int* state,
                           void* row_part, void* col_part, int C, int n, int m, int K,
                           int swap, int R, int warps, int tiles, int splits,
                           int chunks_per_split, void* stream) {
  return launch<double>(params<double>(p, pm, q, qm, out, best, state, row_part, col_part, C,
                                       n, m, K, swap, R, tiles, splits, chunks_per_split),
                        R, warps, stream);
}

}  // extern "C"
