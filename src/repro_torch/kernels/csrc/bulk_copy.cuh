// Asynchronous copies from device memory into shared memory, completing on
// mbarriers: one-dimensional TMA (cp.async.bulk) for fused_decode.cu's count
// rows and race_query.cu's sketch slices, per-thread cp.async for the
// pieces too small to be worth a TMA request each.
//
// A bulk copy needs a 16-byte-aligned source, destination and size.  A row
// segment of a tensor with an odd row length starts anywhere, so
// `bulk_span` widens a byte range [src, src + n) to the 16-byte-aligned
// span around it: at most 15 bytes before and 15 after, which lie in the
// same 16-byte unit as a byte of the range, hence in the same memory page
// (pages are far larger than 16 bytes), so the copy never faults.  The
// extra bytes are never read.  The caller finds its first byte at offset
// `src & 15` of the destination.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and add `bytes` to the transfer count its current
// phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` of the barrier has completed.  A
// wait that has not ended after 10 s traps: a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0)
      t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull)
      __trap();
  }
}

// Add `bytes` to the transfer count of the barrier's current phase, without
// arriving (several threads may each announce their own copies).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Plain arrival on the barrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// 16-byte (both addresses 16-byte aligned) and 4-byte asynchronous copies,
// one thread each (cp.async: no TMA request, so many small pieces issue
// as fast as plain loads).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One arrival on the barrier once every cp.async this thread issued so far
// has landed (the barrier counts it among the arrivals it was made for).
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy (TMA) writes to it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 16-byte-aligned span [lo, lo + bytes) around [src, src + n).
struct Span {
  const void* lo;
  uint32_t bytes;
};

__device__ __forceinline__ Span bulk_span(const void* src, uint32_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~uintptr_t{15};
  const uintptr_t hi = (a + n + 15) & ~uintptr_t{15};
  return {reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo)};
}

// Copy `span` into shared memory at `dst` (16-byte aligned), completing on
// `bar` (whose phase must expect span.bytes).
__device__ __forceinline__ void load(void* dst, Span span, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(span.lo), "r"(span.bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace bulk
