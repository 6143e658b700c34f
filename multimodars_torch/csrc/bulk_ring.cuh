// A ring of shared-memory tiles of 3-D points, filled by TMA bulk copies,
// for Hopper (sm_90a).  Shared by radius_count.cu and nearest.cu.
//
// The point sets stay in the port's [N, 3] layout (12 or 24 bytes a point),
// so a tile's bytes need not start or end on the 16-byte boundary a bulk
// copy needs.  One thread fills a stage: it copies the 16-byte-aligned
// interior with one cp.async.bulk that completes on the stage's mbarrier,
// and the few head and tail elements (at most 16 bytes each side) with plain
// loads and stores before its arrive.  (The CCTA glue starts every packed
// set on a 16-byte boundary, so only a set's last tile has a tail.)  The
// interior lands at the same
// address modulo 16 as its source, so each stage holds one element of slack
// per 4 (float) or 2 (double) bytes of misalignment; a tile's element e sits
// at stage + offset(src) + e.
//
// Protocol (every thread of the block runs it):
//   ring.init()                      thread 0, then __syncthreads()
//   ring.fill(s, src, len)           thread 0: start loading len points
//   ring.wait(s, use)                every thread: stage s's use-th fill done
//   ring.tile(s, src)                the points, x y z of point j at [3 j]
//   __syncthreads()                  before thread 0 refills stage s
// The __syncthreads() after a stage is consumed orders the consumers' reads
// before the next bulk write into it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mmring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T, int kTile, int kStages>
struct PointRing {
  // elements of slack for the source's misalignment, and elements per stage
  // (a multiple of 16 bytes, so every stage starts aligned)
  static constexpr int kSlack = 16 / sizeof(T);
  static constexpr int kStage = 3 * kTile + kSlack;
  static_assert((kStage * sizeof(T)) % 16 == 0, "stage size must be a multiple of 16 bytes");

  alignas(16) T buf[kStages][kStage];
  alignas(8) uint64_t full[kStages];

  static __device__ __forceinline__ int offset(const T* src) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // load points src[0 .. len) (3 elements each), 1 <= len <= kTile.  The
  // bulk copy starts before the head and tail loads, so their latencies
  // overlap; the stage's phase cannot complete before the arrive, which
  // comes last and publishes the head and tail stores.
  __device__ __forceinline__ void fill(int s, const T* src, int len) {
    const int off = offset(src);
    const int ne = 3 * len;
    int head = off ? (16 / static_cast<int>(sizeof(T))) - off : 0;
    head = head < ne ? head : ne;
    const int body = (((ne - head) * static_cast<int>(sizeof(T))) & ~15) / static_cast<int>(sizeof(T));
    T* dst = buf[s] + off;
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t bytes = static_cast<uint32_t>(body * sizeof(T));
    if (bytes) {
      asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(dst + head)), "l"(src + head), "r"(bytes), "r"(bar)
          : "memory");
    }
    for (int e = 0; e < head; ++e) dst[e] = src[e];
    for (int e = head + body; e < ne; ++e) dst[e] = src[e];
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  }

  // wait for the use-th completed fill of stage s (use counts from 0)
  __device__ __forceinline__ void wait(int s, int use) const {
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t parity = static_cast<uint32_t>(use & 1);
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
  }

  __device__ __forceinline__ const T* tile(int s, const T* src) const {
    return buf[s] + offset(src);
  }
};

}  // namespace mmring
