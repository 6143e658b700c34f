// Ray-triangle hits of the CCTA occlusion pass, hand-written for Hopper
// (sm_90a).
//
// What it computes, for every ray r (origin o, direction d, float64) against
// every face f of a triangle list [F, 3, 3] (vertices v0, v1, v2, float64):
//
//   the Moller-Trumbore t of (r, f), valid where the face is not parallel to
//   the ray (|a| >= 1e-8), the barycentric u, v lie in the triangle
//   (u >= 0, u <= 1, v >= 0, u + v <= 1) and t > 1e-8;
//   n_hits[r]  = the number of faces with a valid t;
//   closest[r] = the smallest face index among those with the least valid
//                t, 0 when no face is hit (np.argmin of an all-+inf row);
//   t_min[r]   = that least t, +inf when no face is hit.
//
// The [R, F] t-table itself is never written: at the JAX package's 1e9-pair
// threshold it would take 8 GB.
//
// Replaces the XLA device program _ray_triangle_hits of the JAX package
// (its ccta/kernels.py:1614), whose caller reduces the t-table to each
// ray's hit count and np.argmin (:1747-1748).  Unlike that program, which
// computes in the compute dtype, this kernel always computes in float64:
// every product, sum and difference goes through a round-to-nearest
// intrinsic (__dmul_rn, __dadd_rn, __dsub_rn; 1 / a through __drcp_rn, the
// correctly rounded reciprocal, equal to 1.0 / a) in the order of the host
// twin ccta/kernels.py::_ray_triangle_hits_np, so nvcc contracts nothing
// into an FMA, every t equals the twin's bit for bit, and (n_hits, closest)
// equal the brute scan's.  No certification band is needed.
//
// What bounds it on this card: FP64 operations.  Every (ray, face) pair
// evaluates h = d x e2 (6 mul, 3 sub), a = e1 . h (3 mul, 2 add) and the
// parallel test: 16 operations (the bound, chip_smoke.py::ray_bound),
// against the 64 FP64 lanes of each of the 132 SMs at up to 1980 MHz
// (NVIDIA H100 SXM data sheet).  The faces' 72 bytes each are read once per
// block from the L2, far below the memory rate.
//
// Design.
// 1. The division waits behind an exact filter.  Every pair also forms
//    s = o - v0 (3 sub) and the u numerator un = (sx hx + sy hy) + sz hz
//    (3 mul, 2 add), as the twin rounds them, and drops out without
//    dividing where it is parallel or where the twin's u = RN(RN(1 / a) un)
//    is certainly outside [0, 1] (may_pass_u): with h = RN(RN(a a)(1 +
//    2^-40) / 2) and D = RN(un a - h), one fused multiply-add, where
//    |D| > h.  RN is monotone and h a double, so:
//    - D > h means un a > 2h >= a^2 (1 + 2^-40)(1 - 2^-53)^2, so
//      un / a > 1 + 2^-41, f un > (1 + 2^-41)(1 - 2^-53) > 1 + 2^-42 for
//      f = RN(1 / a), and u rounds above 1;
//    - D < -h means un a - h lies below -h by at least half the gap ulp(h)
//      under -h, so un a < -ulp(h) / 2 <= -2^-54 h: un and f differ in sign
//      and |un / a| > 2^-56, so u rounds to a negative normal number, never
//      to the -0.0 that the twin takes.
//    Since |a| >= 1e-8, a a and h are normal; where they overflow, |D| > h
//    never holds, and a NaN keeps the pair.  A kept pair takes the exact
//    path, the twin's whole path in order (the parallel test, f, u,
//    q = s x e1, v, t).  The occlusion pass's rays keep about 0.5% of the
//    pairs, so a pair costs 22 FP64 operations, the parallel test and 4
//    for the filter (2 mul, an FMA, a compare), where the division first
//    cost about 45.  ops/ray_triangle.py::u_filter_keeps is the same
//    predicate in PyTorch.
// 2. Many rays a block against broadcast faces.  A block holds kThreads
//    neighbouring rays, one a thread in registers with its running (hits,
//    t, face); a thread past the last ray repeats it and writes nothing.
//    It stages its split of the faces (at most kMaxSplit) in shared memory
//    once, as v0, e1 = v1 - v0 and e2 = v2 - v0 (the twin's edges, bit for
//    bit), five 16-byte words a face, and every lane then walks the same
//    faces: each word is one broadcast read serving 32 pairs, and the faces
//    cross from the L2 once per ray group.  A thread filters kStep faces
//    between two votes, so that their chains overlap.  The pairs the
//    filter keeps do not branch the warp: a lane appends each to its warp's ring in shared
//    memory (a ballot and a prefix count), and each time 32 wait the warp
//    takes them through the exact path at once, one a lane; a hit goes by
//    shuffles to the lane of its ray, which keeps the lexicographic least
//    (t, face), so any order of faces gives the twin's answer.  One ray a
//    thread ran faster on the card than two or four, which cost resident
//    warps.
// 3. Whole waves.  Blocks are (split, ray group) items, group fastest.  The
//    host planner (ops/ray_triangle.py::plan) reads the kernel's resident
//    blocks per SM from the card (mm_ray_kernel_info) and cuts the faces
//    into as many splits as fill the fewest whole waves of the SMs at most
//    kMaxSplit faces each.
// 4. One launch.  Each block writes its rays' partial (t, face, hits) for
//    its split; after a __threadfence() it takes a ticket for its (ray
//    group, chunk of kChunk splits), and the last block of a chunk merges
//    the chunk's partials (an integer sum and the lexicographic (t, face)
//    minimum, exact in any order), then takes a ticket for the group, whose
//    last block merges the chunks and writes n_hits, closest and t_min.
//    The block that draws a ticket's last number resets it to 0, so the
//    scratch is ready for the next launch on the stream without a memset.
//    Two levels keep each merge to a few loads a ray.
//    ops/ray_triangle.py::ray_hits_ordered repeats this decomposition in
//    PyTorch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // rays a block, one a thread
constexpr int kMaxSplit = 256;  // faces a block stages (5 x 16 bytes each)
constexpr int kChunk = 16;      // splits the first merge level takes
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;      // a warp's ring of kept pairs
constexpr int kStep = 3;        // faces a thread filters between votes
constexpr int kNoFace = 0x7fffffff;
constexpr double kEps = 1e-8;
// the filter's margin (design 1): (1 + 2^-40) / 2
constexpr double kHalfUp = 0.5 + 0x1p-41;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ bool takes(double t, int f, double bt, int bf) {
  return t < bt || (t == bt && f < bf);
}

// False where the twin's u = RN(RN(1 / a) * un) is certainly outside
// [0, 1] (design 1); |a| >= 1e-8.
__device__ __forceinline__ bool may_pass_u(double a, double un) {
  const double half = mul(mul(a, a), kHalfUp);
  return !(fabs(__fma_rn(un, a, -half)) > half);
}

struct alignas(16) Partial {
  double t;
  int face;
  int hits;
};

struct Ray {
  double ox, oy, oz, dx, dy, dz;
};

// The filter path of one (ray, face) pair: h, a, s and un as the twin
// rounds them, then true unless the pair is parallel or may_pass_u drops
// it.  Branch-free.
__device__ __forceinline__ bool needs_exact(const Ray& r, const double2 (&w)[5]) {
  const double e1x = w[1].y, e1y = w[2].x, e1z = w[2].y;
  const double e2x = w[3].x, e2y = w[3].y, e2z = w[4].x;
  const double hx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const double hy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const double hz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const double a = add(add(mul(e1x, hx), mul(e1y, hy)), mul(e1z, hz));
  const double sx = sub(r.ox, w[0].x);
  const double sy = sub(r.oy, w[0].y);
  const double sz = sub(r.oz, w[1].x);
  const double un = add(add(mul(sx, hx), mul(sy, hy)), mul(sz, hz));
  return !(fabs(a) < kEps) & may_pass_u(a, un);
}

// The twin's whole path for a pair the filter kept: its t where the pair
// is a hit, else +inf (the twin's sentinel, so an overflowed t is no hit).
__device__ __forceinline__ double exact_t(const Ray& r, const double2 (&w)[5]) {
  const double e1x = w[1].y, e1y = w[2].x, e1z = w[2].y;
  const double e2x = w[3].x, e2y = w[3].y, e2z = w[4].x;
  const double hx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const double hy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const double hz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const double a = add(add(mul(e1x, hx), mul(e1y, hy)), mul(e1z, hz));
  if (fabs(a) < kEps) return CUDART_INF;
  const double f = __drcp_rn(a);
  const double sx = sub(r.ox, w[0].x);
  const double sy = sub(r.oy, w[0].y);
  const double sz = sub(r.oz, w[1].x);
  const double u = mul(f, add(add(mul(sx, hx), mul(sy, hy)), mul(sz, hz)));
  if (!(u >= 0.0 && u <= 1.0)) return CUDART_INF;
  const double qx = sub(mul(sy, e1z), mul(sz, e1y));
  const double qy = sub(mul(sz, e1x), mul(sx, e1z));
  const double qz = sub(mul(sx, e1y), mul(sy, e1x));
  const double v = mul(f, add(add(mul(r.dx, qx), mul(r.dy, qy)), mul(r.dz, qz)));
  if (!(v >= 0.0 && add(u, v) <= 1.0)) return CUDART_INF;
  const double t = mul(f, add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)));
  return t > kEps ? t : CUDART_INF;
}

// The merge of `count` partials of ray r, `stride` apart from `p` (written
// by other blocks: read from the L2), into (n, t, f).
__device__ __forceinline__ void merge(const Partial* p, size_t stride, int count, long long& n,
                                      double& t, int& f) {
#pragma unroll 8
  for (int s = 0; s < count; ++s) {
    const double2 w = __ldcg(reinterpret_cast<const double2*>(p + s * stride));
    const long long fh = __double_as_longlong(w.y);
    const int pf = static_cast<int>(fh & 0xffffffffLL);
    n += static_cast<int>(fh >> 32);
    if (takes(w.x, pf, t, f)) {
      t = w.x;
      f = pf;
    }
  }
}

// A block's faces, its threads' rays (o, d) and each warp's ring of kept
// pairs, entries j << 5 | lane (face j of the split, the lane of the ray).
__shared__ double2 faces[kMaxSplit][5];
__shared__ double2 rays[kThreads][3];
__shared__ int queue[kWarps][kQueue];

// A thread's running (hits, t, face) of its ray over its split.
struct Best {
  int hits;
  double t;
  int face;
};

// The warp's n oldest kept pairs from `head` of its ring through the exact
// path, one a lane; each hit goes to the lane that holds its ray, which
// keeps the lexicographic least (t, face).
__device__ __forceinline__ void drain(int warp, int lane, int head, int n, int f0, Best& mine) {
  __syncwarp();
  int entry = 0;
  double t = CUDART_INF;
  if (lane < n) {
    entry = queue[warp][(head + lane) & (kQueue - 1)];
    const int owner = warp * 32 + (entry & 31);
    const double2 q0 = rays[owner][0], q1 = rays[owner][1], q2 = rays[owner][2];
    double2 w[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) w[c] = faces[entry >> 5][c];
    t = exact_t(Ray{q0.x, q0.y, q1.x, q1.y, q2.x, q2.y}, w);
  }
  for (unsigned int found = __ballot_sync(0xffffffffu, t < CUDART_INF); found;
       found &= found - 1) {
    const int from = __ffs(found) - 1;
    const double ht = __shfl_sync(0xffffffffu, t, from);
    const int he = __shfl_sync(0xffffffffu, entry, from);
    if ((he & 31) != lane) continue;
    ++mine.hits;
    if (takes(ht, f0 + (he >> 5), mine.t, mine.face)) {
      mine.t = ht;
      mine.face = f0 + (he >> 5);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void write_out(long long* out, int n_rays, int r, long long n, double t,
                                          int f) {
  out[r] = n;
  out[n_rays + r] = n > 0 ? f : 0;
  reinterpret_cast<double*>(out)[2 * static_cast<size_t>(n_rays) + r] = t;
}

// Block b of the grid is (split b / groups, ray group b % groups).  part:
// [splits, R] partials, then [chunks, R]; tickets: groups * chunks, then
// groups, all 0 and left 0.
__global__ void __launch_bounds__(kThreads)
ray_hits_kernel(const double* __restrict__ origins, const double* __restrict__ dirs,
                const double* __restrict__ tris, int n_rays, int n_faces, int groups,
                int splits, int per_split, Partial* __restrict__ part,
                unsigned int* __restrict__ tickets, long long* __restrict__ out) {
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = blockIdx.x % groups;
  const int split = blockIdx.x / groups;
  const int f0 = split * per_split;
  const int nf = max(0, min(per_split, n_faces - f0));
  const int chunks = (splits + kChunk - 1) / kChunk;
  const int chunk = split / kChunk;
  const int r = group * kThreads + tid;

  for (int j = tid; j < nf; j += kThreads) {
    const double* p = tris + 9 * static_cast<size_t>(f0 + j);
    double v[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) v[c] = __ldg(p + c);
    const double e1x = sub(v[3], v[0]), e1y = sub(v[4], v[1]), e1z = sub(v[5], v[2]);
    const double e2x = sub(v[6], v[0]), e2y = sub(v[7], v[1]), e2z = sub(v[8], v[2]);
    faces[j][0] = make_double2(v[0], v[1]);
    faces[j][1] = make_double2(v[2], e1x);
    faces[j][2] = make_double2(e1y, e1z);
    faces[j][3] = make_double2(e2x, e2y);
    faces[j][4] = make_double2(e2z, 0.0);
  }
  const int rc = min(r, n_rays - 1);
  const Ray ray{origins[3 * rc], origins[3 * rc + 1], origins[3 * rc + 2],
                dirs[3 * rc],    dirs[3 * rc + 1],    dirs[3 * rc + 2]};
  rays[tid][0] = make_double2(ray.ox, ray.oy);
  rays[tid][1] = make_double2(ray.oz, ray.dx);
  rays[tid][2] = make_double2(ray.dy, ray.dz);
  Best mine{0, CUDART_INF, kNoFace};
  __syncthreads();

  // the filter path for every face; the pairs it keeps wait in the warp's
  // ring, and each time 32 wait the warp takes them through the exact path
  int head = 0, waiting = 0;  // the same in every lane of the warp
  for (int j0 = 0; j0 < nf; j0 += kStep) {
    // kStep faces' filter paths before the first vote, so that they overlap
    bool need[kStep];
#pragma unroll
    for (int q = 0; q < kStep; ++q) {
      const int j = min(j0 + q, nf - 1);
      double2 w[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) w[c] = faces[j][c];
      need[q] = needs_exact(ray, w) & (j0 + q < nf);
    }
#pragma unroll
    for (int q = 0; q < kStep; ++q) {
      const unsigned int kept = __ballot_sync(0xffffffffu, need[q]);
      if (!kept) continue;
      if (need[q]) {
        const int at = head + waiting + __popc(kept & ((1u << lane) - 1u));
        queue[warp][at & (kQueue - 1)] = (j0 + q) << 5 | lane;
      }
      waiting += __popc(kept);
      if (waiting >= 32) {
        drain(warp, lane, head, 32, f0, mine);
        head += 32;
        waiting -= 32;
      }
    }
  }
  if (waiting > 0) drain(warp, lane, head, waiting, f0, mine);

  // this split's partial, then the last block of the (group, chunk) merges
  // the chunk's, and the last of those the group's chunks
  if (r < n_rays) part[static_cast<size_t>(split) * n_rays + r] = Partial{mine.t, mine.face, mine.hits};
  const int first = chunk * kChunk;
  const int in_chunk = min(kChunk, splits - first);
  unsigned int* ticket = tickets + group * chunks + chunk;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(in_chunk - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  Partial* level2 = part + static_cast<size_t>(splits) * n_rays;
  long long n = 0;
  double t = CUDART_INF;
  int f = kNoFace;
  if (r < n_rays) {
    merge(part + static_cast<size_t>(first) * n_rays + r, n_rays, in_chunk, n, t, f);
    if (chunks == 1) {
      write_out(out, n_rays, r, n, t, f);
    } else {
      level2[static_cast<size_t>(chunk) * n_rays + r] = Partial{t, f, static_cast<int>(n)};
    }
  }
  if (tid == 0) *ticket = 0u;
  if (chunks == 1) return;
  ticket = tickets + groups * chunks + group;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned int>(chunks - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (r < n_rays) {
    n = 0;
    t = CUDART_INF;
    f = kNoFace;
    merge(level2 + r, n_rays, chunks, n, t, f);
    write_out(out, n_rays, r, n, t, f);
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

extern "C" {

const char* mm_ray_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// info[0..6]: registers a thread, local (spilled) bytes a thread, static
// shared bytes a block, resident blocks per SM, rays a block, faces a split
// at most, splits a merge chunk.  Returns 0 or a CUDA error.
int mm_ray_kernel_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ray_hits_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ray_hits_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = blocks;
  info[4] = kThreads;
  info[5] = kMaxSplit;
  info[6] = kChunk;
  return 0;
}

// origins, dirs: [R, 3]; tris: [F, 3, 3] (all float64, device); partial:
// device scratch of 16 * (splits + chunks) * R bytes; tickets: groups *
// (chunks + 1) words, 0, left 0; out: [3, R] 8-byte words.  groups =
// ceil(R / kThreads), chunks = ceil(splits / kChunk).
int mm_ray_hits(const double* origins, const double* dirs, const double* tris, int n_rays,
                int n_faces, int groups, int splits, int per_split, void* partial,
                unsigned int* tickets, int64_t* out, void* stream) {
  if (n_rays < 0 || n_faces < 0 || splits < 1 || per_split < 1 || per_split > kMaxSplit ||
      groups != (n_rays + kThreads - 1) / kThreads ||
      static_cast<long long>(splits) * per_split < static_cast<long long>(n_faces) ||
      static_cast<long long>(splits) * groups > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  ray_hits_kernel<<<groups * splits, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      origins, dirs, tris, n_rays, n_faces, groups, splits, per_split,
      static_cast<Partial*>(partial), tickets, reinterpret_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
