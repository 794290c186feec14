// Bulk copies from global to shared memory by the Tensor Memory Accelerator
// (cp.async.bulk, sm_90), completed on an mbarrier, for the pipelined reads
// of the generated adjoint recursion (ops/circuit_codegen.py, B8).  One
// thread queues a whole contiguous slab (a multiple of 16 bytes, 16-byte
// aligned at both ends) and tells the stage's mbarrier how many bytes to
// expect; every thread that reads the stage waits on the barrier's phase.
// The copy takes no registers and no load instructions of the waiting warp,
// so a warp can keep many slabs in flight.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier expecting `count` arrivals a phase
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the bulk-copy unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, announcing `bytes` of copies to complete the phase
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_address(bar)), "r"(phase)
        : "memory");
  }
}

// copy `bytes` from global `src` to shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

}  // namespace
