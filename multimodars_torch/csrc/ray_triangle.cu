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
// ray's hit count and np.argmin (:1747-1748).  Unlike that program,
// which computes in the compute dtype, this kernel always computes in
// float64: every product, sum and difference goes through a round-to-nearest
// intrinsic (__dmul_rn, __dadd_rn, __dsub_rn; 1 / a through __ddiv_rn) in the
// order of the host twin ccta/kernels.py::_ray_triangle_hits_np, so nvcc
// contracts nothing into an FMA, every t equals the twin's bit for bit, and
// (n_hits, closest) equal the brute scan's.  No certification band is needed.
//
// What bounds it on this card: FP64 operations.  Before its first early-out
// every (ray, face) pair evaluates h = d x e2 (6 mul, 3 sub), a = e1 . h
// (3 mul, 2 add) and the parallel test (2): 16 operations, against the 64
// FP64 lanes of each of the 132 SMs at up to 1980 MHz (NVIDIA H100 SXM data
// sheet).  The faces' 72 bytes each are read once per block from device
// memory (the L2 holds them), which is far below the memory rate.
//
// Design.  The occlusion pass has few rays (an aorta centerline times a
// strided coronary centerline: 1000 on the 57,606-vertex case) against tens
// of thousands of faces, so one thread per ray would leave the card idle.
// - Grid (ceil(R / 8), S): a block of 8 warps holds 8 rays, one a warp, and
//   split s of the face list (S contiguous ranges of whole 256-face tiles,
//   chosen by ops/ray_triangle.py::plan from R, F and the SM count).
// - The block stages each tile of its range in shared memory as v0, e1 =
//   v1 - v0 and e2 = v2 - v0 (the twin's edges, bit for bit), and the 32
//   lanes of a warp take faces lane, lane + 32, ... of the tile against
//   their ray, in increasing face order with a strict compare, so a lane
//   keeps the first face of its least t.
// - Warp shuffles merge the lanes: hits summed, (t, face) lexicographic
//   minimum.  Lane 0 writes the warp's partial (hits, t, face) of split s.
// - A finishing kernel, one thread a ray, merges the S partials in split
//   order the same way and writes n_hits, closest and t_min.  A minimum over
//   a set and an integer sum are exact, so every split and lane count gives
//   the single scan's answer.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // faces a block stages at a time
constexpr int kNoFace = 0x7fffffff;
constexpr double kEps = 1e-8;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ bool takes(double t, int f, double bt, int bf) {
  return t < bt || (t == bt && f < bf);
}

// partial layout: t [S * R] doubles, then hits [S * R] and face [S * R] int32
__global__ void __launch_bounds__(kThreads)
ray_partials_kernel(const double* __restrict__ origins, const double* __restrict__ dirs,
                    const double* __restrict__ tris, int n_rays, int n_faces, int per_split,
                    double* __restrict__ part_t, int* __restrict__ part_hits,
                    int* __restrict__ part_face) {
  __shared__ double v0[3][kTile];
  __shared__ double e1[3][kTile];
  __shared__ double e2[3][kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + warp;
  const bool live = ray < n_rays;
  const int split = blockIdx.y;
  const int f_begin = split * per_split;
  const int f_end = min(n_faces, f_begin + per_split);

  double ox = 0.0, oy = 0.0, oz = 0.0, dx = 0.0, dy = 0.0, dz = 0.0;
  if (live) {
    ox = origins[3 * ray];
    oy = origins[3 * ray + 1];
    oz = origins[3 * ray + 2];
    dx = dirs[3 * ray];
    dy = dirs[3 * ray + 1];
    dz = dirs[3 * ray + 2];
  }
  int hits = 0;
  double best_t = CUDART_INF;
  int best_f = kNoFace;

  for (int tile = f_begin; tile < f_end; tile += kTile) {
    const int n_tile = min(kTile, f_end - tile);
    __syncthreads();  // the previous tile is no longer read
    if (threadIdx.x < n_tile) {
      const double* p = tris + 9 * static_cast<size_t>(tile + threadIdx.x);
      const int j = threadIdx.x;
      for (int c = 0; c < 3; ++c) {
        v0[c][j] = p[c];
        e1[c][j] = sub(p[3 + c], p[c]);
        e2[c][j] = sub(p[6 + c], p[c]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = lane; j < n_tile; j += 32) {
      const double e1x = e1[0][j], e1y = e1[1][j], e1z = e1[2][j];
      const double e2x = e2[0][j], e2y = e2[1][j], e2z = e2[2][j];
      const double hx = sub(mul(dy, e2z), mul(dz, e2y));
      const double hy = sub(mul(dz, e2x), mul(dx, e2z));
      const double hz = sub(mul(dx, e2y), mul(dy, e2x));
      const double a = add(add(mul(e1x, hx), mul(e1y, hy)), mul(e1z, hz));
      if (fabs(a) < kEps) continue;
      const double f = __ddiv_rn(1.0, a);
      const double sx = sub(ox, v0[0][j]);
      const double sy = sub(oy, v0[1][j]);
      const double sz = sub(oz, v0[2][j]);
      const double u = mul(f, add(add(mul(sx, hx), mul(sy, hy)), mul(sz, hz)));
      if (!(u >= 0.0 && u <= 1.0)) continue;
      const double qx = sub(mul(sy, e1z), mul(sz, e1y));
      const double qy = sub(mul(sz, e1x), mul(sx, e1z));
      const double qz = sub(mul(sx, e1y), mul(sy, e1x));
      const double v = mul(f, add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)));
      if (!(v >= 0.0 && add(u, v) <= 1.0)) continue;
      const double t = mul(f, add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)));
      if (!(t > kEps)) continue;
      ++hits;
      if (t < best_t) {
        best_t = t;
        best_f = tile + j;
      }
    }
  }
  if (!live) return;
  for (int off = 16; off > 0; off >>= 1) {
    hits += __shfl_xor_sync(0xffffffffu, hits, off);
    const double ot = __shfl_xor_sync(0xffffffffu, best_t, off);
    const int of = __shfl_xor_sync(0xffffffffu, best_f, off);
    if (takes(ot, of, best_t, best_f)) {
      best_t = ot;
      best_f = of;
    }
  }
  if (lane == 0) {
    const size_t o = static_cast<size_t>(split) * n_rays + ray;
    part_t[o] = best_t;
    part_hits[o] = hits;
    part_face[o] = best_f;
  }
}

// out: [3, R] 8-byte words: n_hits (int64), closest (int64), t_min (double)
__global__ void __launch_bounds__(kThreads)
ray_finish_kernel(int n_rays, int splits, const double* __restrict__ part_t,
                  const int* __restrict__ part_hits, const int* __restrict__ part_face,
                  int64_t* __restrict__ out) {
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  if (ray >= n_rays) return;
  long long hits = 0;
  double best_t = CUDART_INF;
  int best_f = kNoFace;
  for (int s = 0; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * n_rays + ray;
    hits += part_hits[o];
    if (takes(part_t[o], part_face[o], best_t, best_f)) {
      best_t = part_t[o];
      best_f = part_face[o];
    }
  }
  out[ray] = hits;
  out[n_rays + ray] = hits > 0 ? best_f : 0;
  reinterpret_cast<double*>(out)[2 * static_cast<size_t>(n_rays) + ray] = best_t;
}

}  // namespace

extern "C" {

const char* mm_ray_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// origins, dirs: [R, 3]; tris: [F, 3, 3] (all float64, device); partial:
// device scratch of 16 * splits * R bytes; out: [3, R] 8-byte words.
int mm_ray_hits(const double* origins, const double* dirs, const double* tris, int n_rays,
                int n_faces, int splits, int per_split, void* partial, int64_t* out,
                void* stream) {
  if (n_rays < 0 || n_faces < 0 || splits < 1 || splits > 65535 || per_split < 0 ||
      per_split % kTile != 0 ||
      static_cast<long long>(splits) * per_split < static_cast<long long>(n_faces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays == 0) return 0;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t cells = static_cast<size_t>(splits) * n_rays;
  double* part_t = static_cast<double*>(partial);
  int* part_hits = reinterpret_cast<int*>(part_t + cells);
  int* part_face = part_hits + cells;
  const dim3 grid((n_rays + kWarps - 1) / kWarps, splits);
  ray_partials_kernel<<<grid, kThreads, 0, st>>>(origins, dirs, tris, n_rays, n_faces,
                                                  per_split, part_t, part_hits, part_face);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ray_finish_kernel<<<(n_rays + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      n_rays, splits, part_t, part_hits, part_face, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
