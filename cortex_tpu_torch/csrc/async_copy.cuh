// Hopper's bulk copies (the 1-D form of the Tensor Memory Accelerator) and the shared-memory
// barriers they complete on, as inline PTX for sm_90a.  K1 (lgssm_smooth.cu) stages its
// tiles and stores its marginals with them.  Below them, the per-thread asynchronous copies
// (cp.async, 4 or 16 bytes), with which K2/K3 (hmm_forward_backward.cu) stage their rows of
// lik.
//
// A bulk copy moves a contiguous run of bytes between device and shared memory without the
// issuing thread's registers: both addresses 16-byte aligned, the size a multiple of 16.  A
// load completes on an mbarrier (its transaction count falls by the bytes that landed); a
// store joins the issuing thread's bulk group, which the thread waits on before the shared
// memory it reads may be reused or the block may exit.

#pragma once

#include <cstdint>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier for `count` arrivals, then the block synchronises.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count the current phase waits for.
__device__ __forceinline__ void barrier_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Device memory -> shared memory, completing on `bar`.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Make this thread's ordinary writes to shared memory visible to the bulk copies it issues next.
__device__ __forceinline__ void fence_shared_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared memory -> device memory, in this thread's current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk groups have read their shared memory.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Per-thread asynchronous copies, device memory -> shared memory: 16 bytes (both addresses
// 16-byte aligned; cached in L2 only) or 4 bytes.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Wait until every copy this thread issued has landed.  Other threads see the copied data
// after a barrier that follows the wait.
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

}  // namespace async_copy
