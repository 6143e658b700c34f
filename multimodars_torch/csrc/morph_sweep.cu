// Cost tables of the centerline-morph sweep, hand-written for Hopper
// (sm_90a): up to kMaxSweeps sweeps in one launch.
//
// What it computes, for each sweep s of a launch and every offset k < K_s of
// xs, with moved points p_i(k) = points[i] + unit[i] * xs[k] (points, unit
// [n, 3]) against the reference set r_j (reference [m, 3], n, m >= 1):
//
//   d2(i, j, k) = ((px - rx)^2 + (py - ry)^2) + (pz - rz)^2
//   fwd[s, k] = sum_i min_j d2(i, j, k)      (moved -> reference)
//   bwd[s, k] = sum_j min_i d2(i, j, k)      (reference -> moved)
//
// The host takes cost[k] = sqrt((fwd[k] / n + bwd[k] / m) / 2).  This is
// _sweep_cost_table of the JAX package (ccta/kernels.py:2183,
// the grid sweep of scale_coronary.rs:65-130), an XLA program there; its row
// masks existed for padded jit shapes, and the port passes the sets at their
// size.  The glue keeps _sweep_finish's certification: every offset whose
// cost lies within 2 cmin 1e-4 + 1e-12 of the minimum is re-evaluated
// exactly in float64 on the host.  d2 and the moved point are evaluated with
// round-to-nearest intrinsics (no FMA contraction), as the plain version
// rounds them.
//
// What bounds it on this card: FP32 (FP64) instruction issue.  One d2 per
// (offset, pair) serves both directions: 3 sub, 3 mul, 2 add and the two
// minima, 10 operations.  The scale stage's three sweeps are 46 M such
// pairs, 14 us at the FP32 peak, so latency and launches weigh as much.
//
// Design.
// - One launch takes up to kMaxSweeps sweeps from a descriptor table passed
//   by value.  Work items are (sweep, group of kOffsets offsets, row tile,
//   column split), numbered sweep by sweep, group major; the host planner
//   (ops/morph_sweep.py::plan) sizes the splits so that the items fill the
//   card's resident blocks in whole waves.
// - A block owns kRows moved rows (kRowsPerThread a thread) at kOffsets
//   offsets, all held in registers, and one column split (at most kMaxSplit
//   reference points), loaded once into shared memory with coalesced loads.
//   Each reference point read from shared memory serves kRowsPerThread x
//   kOffsets pairs.  A row past the end sits at +inf and a padded reference
//   point at -inf, so their d2 is +inf (never NaN) and moves no minimum.
// - Column minima: a thread folds its rows into per-thread minima for a
//   chunk of kChunk reference points x kOffsets offsets (32 values), and
//   the warp reduces those 32 values at once with a transposing butterfly
//   (31 shuffles, after which lane l holds the minimum of value l): about 4
//   instructions a value, shared by the thread's kRowsPerThread rows.  Lane l
//   then lowers one word of the block's shared column minima with atomicMin
//   on the bits of non-negative floats, which order like the floats.
// - No second kernel and no fill: each block lowers the sweep's row minima
//   [K, n] and column minima [K, m] in a scratch of words with atomicMin on
//   the bits (fire-and-forget reductions in L2, exact in any order); after a
//   __threadfence() it takes a ticket for its (sweep, group), and the last
//   block of the group reads those minima back (one word per row and column,
//   independent loads), sums them in a fixed order (a thread's strided
//   share in index order, a warp butterfly, the warps in turn), writes fwd
//   and bwd, and resets the words to all ones (above the bits of every
//   non-negative float) and the ticket to 0.  The scratch is therefore ready
//   for the next launch on the stream without a memset: the wrapper keeps
//   it per device, dtype and stream and fills it once when it grows.  The
//   sums are the same from run to run and do not depend on the plan;
//   ops/morph_sweep.py's morph_sweep_ordered repeats them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOffsets = 2;
constexpr int kChunk = 16;  // kChunk x kOffsets = 32 values a warp reduces at once
constexpr int kMaxSweeps = 4;
constexpr int kDescInts = 16;

static_assert(kChunk * kOffsets == 32, "the transposing butterfly reduces 32 values");

struct alignas(16) F4 { float x, y, z, w; };
struct alignas(16) D4 { double x, y, z, w; };

// one sweep of a launch; offsets count points of the point, unit and
// reference buffers, words of the scratch, and tickets
struct Sweep {
  int p_off, n, r_off, m, K, splits, per_split, tiles, groups, item_begin;
  int row_off, col_off, ticket_off;
};
struct Batch {
  int nsweeps;
  Sweep s[kMaxSweeps];
};

template <typename T> struct Traits;
template <> struct Traits<float> {
  using Vec = F4;
  using Bits = unsigned int;
  static constexpr int kRowsPerThread = 8;
  static constexpr int kMaxSplit = 1024;
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
  static __device__ __forceinline__ float d2(float ax, float ay, float az, const F4& b) {
    const float dx = __fsub_rn(ax, b.x);
    const float dy = __fsub_rn(ay, b.y);
    const float dz = __fsub_rn(az, b.z);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  static __device__ __forceinline__ float moved(float p, float u, float x) {
    return __fadd_rn(p, __fmul_rn(u, x));
  }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ float value(Bits v) { return __uint_as_float(v); }
};
template <> struct Traits<double> {
  using Vec = D4;
  using Bits = unsigned long long;
  static constexpr int kRowsPerThread = 4;
  static constexpr int kMaxSplit = 512;
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
  static __device__ __forceinline__ double d2(double ax, double ay, double az, const D4& b) {
    const double dx = __dsub_rn(ax, b.x);
    const double dy = __dsub_rn(ay, b.y);
    const double dz = __dsub_rn(az, b.z);
    return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
  }
  static __device__ __forceinline__ double moved(double p, double u, double x) {
    return __dadd_rn(p, __dmul_rn(u, x));
  }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  // no NaN reaches a minimum (see the padding above), so a compare and a
  // select do, where fmin would also test for NaN
  static __device__ __forceinline__ double min(double a, double b) { return b < a ? b : a; }
  static __device__ __forceinline__ Bits bits(double v) {
    return static_cast<unsigned long long>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double value(Bits v) {
    return __longlong_as_double(static_cast<long long>(v));
  }
};

// one step of transpose_min32: the lane whose bit H is set keeps the upper
// half of v[0 .. 2H) and sends the lower, its partner the opposite; each
// keeps the minimum of its half and the half it receives in v[0 .. H).
// H is a template argument so that every index is a constant and v stays
// in registers.
template <int H, typename T>
__device__ __forceinline__ void transpose_min_step(T (&v)[32], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const T send = upper ? v[i] : v[i + H];
    const T keep = upper ? v[i + H] : v[i];
    v[i] = Traits<T>::min(keep, __shfl_xor_sync(0xffffffffu, send, H));
  }
}

// the minimum over the warp of each of the 32 values v[0..31] of every lane;
// lane l returns the minimum of value l (31 shuffles in all)
template <typename T>
__device__ __forceinline__ T transpose_min32(T (&v)[32], int lane) {
  transpose_min_step<16>(v, lane);
  transpose_min_step<8>(v, lane);
  transpose_min_step<4>(v, lane);
  transpose_min_step<2>(v, lane);
  transpose_min_step<1>(v, lane);
  return v[0];
}

// the sums of V values per thread over the block, each in a fixed order: a
// warp butterfly, then the warps in turn; the totals are valid in thread 0
template <int V, typename T>
__device__ __forceinline__ void block_sums(T (&v)[V], T (*red)[kWarps]) {
#pragma unroll
  for (int q = 0; q < V; ++q) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      v[q] = Traits<T>::add(v[q], __shfl_xor_sync(0xffffffffu, v[q], offset));
    if ((threadIdx.x & 31) == 0) red[q][threadIdx.x >> 5] = v[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      v[q] = red[q][0];
      for (int w = 1; w < kWarps; ++w) v[q] = Traits<T>::add(v[q], red[q][w]);
    }
  }
}

// grid: one block per work item; out [2, nsweeps, out_k] (fwd, then bwd)
template <typename T>
__global__ void __launch_bounds__(kThreads)
morph_sweep_kernel(const T* __restrict__ points, const T* __restrict__ unit,
                   const T* __restrict__ ref, const T* __restrict__ xs, const Batch batch,
                   int out_k, T* __restrict__ out, typename Traits<T>::Bits* __restrict__ words,
                   unsigned int* __restrict__ tickets) {
  using Tr = Traits<T>;
  using V = typename Tr::Vec;
  using Bits = typename Tr::Bits;
  constexpr int R = Tr::kRowsPerThread;
  constexpr int kRows = kThreads * R;
  constexpr int kMaxSplit = Tr::kMaxSplit;
  __shared__ V tile[kMaxSplit];
  __shared__ Bits col_min[kOffsets][kMaxSplit];
  __shared__ T red[2 * kOffsets][kWarps];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int item = blockIdx.x;
  int si = 0;
  while (si + 1 < batch.nsweeps && item >= batch.s[si + 1].item_begin) ++si;
  const Sweep S = batch.s[si];
  const int local = item - S.item_begin;
  const int split = local % S.splits;
  const int row_tile = (local / S.splits) % S.tiles;
  const int group = local / (S.splits * S.tiles);
  const int k0 = group * kOffsets;
  const int j0 = split * S.per_split;
  const int len = min(S.per_split, S.m - j0);
  const int padded = (len + kChunk - 1) / kChunk * kChunk;
  const int row0 = row_tile * kRows;
  const T inf = Tr::inf();

  // the split's reference points, padded to whole chunks at -inf
  const T* rp = ref + 3 * (static_cast<size_t>(S.r_off) + j0);
  for (int j = tid; j < padded; j += kThreads) {
    if (j < len) {
      tile[j] = V{rp[3 * j], rp[3 * j + 1], rp[3 * j + 2], T(0)};
    } else {
      tile[j] = V{-inf, -inf, -inf, T(0)};
    }
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) col_min[k][j] = Tr::bits(inf);
  }

  // the moved rows; an offset past K repeats the last (never written)
  T px[R][kOffsets], py[R][kOffsets], pz[R][kOffsets], row_min[R][kOffsets];
  T x[kOffsets];
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) x[k] = xs[min(k0 + k, S.K - 1)];
  const T* pp = points + 3 * static_cast<size_t>(S.p_off);
  const T* up = unit + 3 * static_cast<size_t>(S.p_off);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * kThreads + tid;
    const bool live = i < S.n;
    const size_t o = 3 * static_cast<size_t>(live ? i : 0);
    const T ax = pp[o], ay = pp[o + 1], az = pp[o + 2];
    const T ux = up[o], uy = up[o + 1], uz = up[o + 2];
#pragma unroll
    for (int k = 0; k < kOffsets; ++k) {
      px[r][k] = live ? Tr::moved(ax, ux, x[k]) : inf;
      py[r][k] = live ? Tr::moved(ay, uy, x[k]) : inf;
      pz[r][k] = live ? Tr::moved(az, uz, x[k]) : inf;
      row_min[r][k] = inf;
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < padded; c0 += kChunk) {
    T cm[kChunk * kOffsets];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const V q = tile[c0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int k = 0; k < kOffsets; ++k) {
          const T d = Tr::d2(px[r][k], py[r][k], pz[r][k], q);
          row_min[r][k] = Tr::min(row_min[r][k], d);
          cm[c * kOffsets + k] = r == 0 ? d : Tr::min(cm[c * kOffsets + k], d);
        }
      }
    }
    const T v = transpose_min32(cm, lane);
    const int c = lane / kOffsets;
    if (c0 + c < len) atomicMin(&col_min[lane % kOffsets][c0 + c], Tr::bits(v));
  }
  __syncthreads();

  // this item's minima into the sweep's row and column minima
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) {
    if (k0 + k >= S.K) continue;
    Bits* rows = words + S.row_off + static_cast<size_t>(k0 + k) * S.n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r * kThreads + tid;
      if (i < S.n) atomicMin(rows + i, Tr::bits(row_min[r][k]));
    }
    Bits* cols = words + S.col_off + static_cast<size_t>(k0 + k) * S.m + j0;
    for (int j = tid; j < len; j += kThreads) atomicMin(cols + j, col_min[k][j]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int done = atomicAdd(tickets + S.ticket_off + group, 1u);
    is_last = done == static_cast<unsigned int>(S.tiles * S.splits - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block of the group: the minima of its offsets, summed in a
  // fixed order (all loads first, then one block reduction for the 2 x
  // kOffsets sums), and the words and the ticket reset for the next launch
  const int kn = min(kOffsets, S.K - k0);
  Bits* rows = words + S.row_off + static_cast<size_t>(k0) * S.n;
  Bits* cols = words + S.col_off + static_cast<size_t>(k0) * S.m;
  T sums[2 * kOffsets];
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) {
    sums[k] = T(0);
    sums[kOffsets + k] = T(0);
    if (k >= kn) continue;
#pragma unroll 8
    for (int i = tid; i < S.n; i += kThreads)
      sums[k] = Tr::add(sums[k], Tr::value(__ldcg(rows + static_cast<size_t>(k) * S.n + i)));
#pragma unroll 8
    for (int j = tid; j < S.m; j += kThreads)
      sums[kOffsets + k] = Tr::add(sums[kOffsets + k],
                                   Tr::value(__ldcg(cols + static_cast<size_t>(k) * S.m + j)));
  }
  block_sums(sums, red);
  if (tid == 0) {
    for (int k = 0; k < kn; ++k) {
      out[static_cast<size_t>(si) * out_k + k0 + k] = sums[k];
      out[(static_cast<size_t>(batch.nsweeps) + si) * out_k + k0 + k] = sums[kOffsets + k];
    }
    tickets[S.ticket_off + group] = 0u;
  }
  const Bits ones = ~Bits(0);
  for (int e = tid; e < kn * S.n; e += kThreads) rows[e] = ones;
  for (int e = tid; e < kn * S.m; e += kThreads) cols[e] = ones;
  // offsets past the sweep's K read 0
  if (group == 0) {
    for (int k = S.K + tid; k < out_k; k += kThreads) {
      out[static_cast<size_t>(si) * out_k + k] = T(0);
      out[(static_cast<size_t>(batch.nsweeps) + si) * out_k + k] = T(0);
    }
  }
}

template <typename T>
int launch(const T* points, const T* unit, const T* ref, const T* xs, const int* desc,
           int nsweeps, int nitems, int out_k, T* out, void* words, unsigned int* tickets,
           void* stream) {
  if (nsweeps < 1 || nsweeps > kMaxSweeps || nitems < 1 || out_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Batch batch{};
  batch.nsweeps = nsweeps;
  int items = 0;
  for (int s = 0; s < nsweeps; ++s) {
    const int* d = desc + kDescInts * s;
    const Sweep w{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11], d[12]};
    if (w.n < 1 || w.m < 1 || w.K < 1 || w.K > out_k || w.item_begin != items || w.splits < 1 ||
        w.tiles < 1 || w.per_split < 1 || w.per_split > Traits<T>::kMaxSplit ||
        static_cast<long long>(w.splits) * w.per_split < w.m ||
        static_cast<long long>(w.tiles) * kThreads * Traits<T>::kRowsPerThread < w.n ||
        w.groups != (w.K + kOffsets - 1) / kOffsets) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    batch.s[s] = w;
    items += w.groups * w.tiles * w.splits;
  }
  if (items != nitems) return static_cast<int>(cudaErrorInvalidValue);
  morph_sweep_kernel<T><<<nitems, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      points, unit, ref, xs, batch, out_k, out,
      reinterpret_cast<typename Traits<T>::Bits*>(words), tickets);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, morph_sweep_kernel<T>, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* mm_morph_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the kernel one SM holds at once (negative: minus a CUDA error).
int mm_morph_sweep_blocks_per_sm(int f64) {
  return f64 ? blocks_per_sm<double>() : blocks_per_sm<float>();
}

// desc: nsweeps rows of 16 int32 (p_off, n, r_off, m, K, splits, per_split,
// tiles, groups, item_begin, row_off, col_off, ticket_off, 0, 0, 0), host
// memory.  out: [2, nsweeps, out_k] on the device, every entry written.
// words: every sweep's row minima [K, n] at row_off and column minima
// [K, m] at col_off, 32-bit (f32) or 64-bit (f64) words all ones; tickets:
// one per (sweep, offset group), 0.  The launch leaves both as it found them.
int mm_morph_sweep_f32(const float* points, const float* unit, const float* ref,
                       const float* xs, const int* desc, int nsweeps, int nitems, int out_k,
                       float* out, void* words, unsigned int* tickets, void* stream) {
  return launch<float>(points, unit, ref, xs, desc, nsweeps, nitems, out_k, out, words,
                       tickets, stream);
}

int mm_morph_sweep_f64(const double* points, const double* unit, const double* ref,
                       const double* xs, const int* desc, int nsweeps, int nitems, int out_k,
                       double* out, void* words, unsigned int* tickets, void* stream) {
  return launch<double>(points, unit, ref, xs, desc, nsweeps, nitems, out_k, out, words,
                        tickets, stream);
}

}  // extern "C"
