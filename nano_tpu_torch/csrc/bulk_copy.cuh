// Bulk copies from global to shared memory with completion on an mbarrier
// (cp.async.bulk, 1-D: no tensor map, no registers or instructions spent
// on addresses), shared by the B = 1 products that stream weight tiles
// into a ring of stages: q80_matmul.cu's q80_matvec_fq and
// q80_matvec_rows, q4k.cu's q4k_matvec_fq.
#pragma once

#include <stdint.h>

namespace {

namespace bulk {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

// After the barriers' initialization, before any other thread or the copy
// engine may use them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive (release: this thread's earlier shared-memory stores become
// visible to the waiters) and add `bytes` to the phase's expected bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completion counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// n bytes at global src, to be copied to `dst` in shared memory, where dst
// and src agree modulo 16 (a buffer of n + 16 bytes, 16-byte aligned, and
// dst = buffer + src % 16): its 16-byte aligned middle goes by bulk copy,
// its < 16-byte ends by plain loads of the calling thread.
struct CopyIn {
  uintptr_t a, am, bm, b;   // [a, b) and its aligned middle [am, bm)
  unsigned char* dst;
  __device__ CopyIn(unsigned char* buf, const void* src, size_t n) {
    a = (uintptr_t)src;
    b = a + n;
    am = (a + 15) & ~(uintptr_t)15;
    bm = b & ~(uintptr_t)15;
    if (bm < am) bm = am;
    dst = buf + (a & 15);
  }
  __device__ uint32_t bulk_bytes() const { return (uint32_t)(bm - am); }
  // the ends: before the arrive that releases them
  __device__ void ends() const {
    for (uintptr_t p = a; p < (am < b ? am : b); ++p) dst[p - a] = *(const unsigned char*)p;
    for (uintptr_t p = bm; p < b; ++p) dst[p - a] = *(const unsigned char*)p;
  }
  // the middle: after the arrive
  __device__ void bulk(uint64_t* bar) const {
    if (bm > am) bulk_copy(dst + (am - a), (const void*)am, (uint32_t)(bm - am), bar);
  }
};

// Bytes of a buffer for n bytes copied in by CopyIn, rounded to 16.
__host__ __device__ __forceinline__ size_t copy_in_bytes(size_t n) {
  return (n + 16 + 15) & ~(size_t)15;
}

}  // namespace bulk

}  // namespace
