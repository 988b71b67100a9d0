// Bulk async copies (cp.async.bulk) from global into shared memory, each
// completing on an mbarrier; shared by lss_topk.cu and bucket_logits.cu.
//
// A 1D bulk copy needs a 16-byte-aligned source, destination and size.
// Slab rows of d = 129 (516 B in fp32, 258 B in bf16) are not, so a
// caller rounds each span out to 16 B at both ends (bulk_span) and reads
// its rows at the span's offset inside the stage.  The extra bytes lie in
// the same 16-byte granules as wanted ones, so in mapped memory, and are
// never used.
#pragma once

#include <cstdint>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Completes the barrier's phase with no bytes to wait for (an empty copy).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// A copy that never lands (a fault) traps after ~10 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// One thread copies `bytes` (a multiple of 16) from 16-byte-aligned global
// `src` to 16-byte-aligned shared `dst`; `bar` completes its phase when
// they have landed.  `reused`: the stage held an earlier chunk, which the
// warp's generic loads read, so order those before the async writes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          bool reused) {
  if (reused) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// [src, src + bytes) rounded out to 16 B at both ends: the copy starts at
// `lo` and moves `size` bytes (< bytes + 32); the span's first byte lies
// `src - lo` (< 16) bytes into it.
struct BulkSpan {
  uintptr_t lo;
  unsigned size;
};

__device__ __forceinline__ BulkSpan bulk_span(const void* src, size_t bytes) {
  const auto a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uintptr_t hi = (a + bytes + 15) & ~uintptr_t{15};
  return {lo, static_cast<unsigned>(hi - lo)};
}
