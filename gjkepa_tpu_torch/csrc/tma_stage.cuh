// The staging primitives of K1 (gjk_hulls.cu, stage_pairs) and K12
// (gjk_hulls_big.cu, stage_hulls): one bulk copy of the Tensor Memory
// Accelerator (TMA, Hopper's copy engine) from device memory into shared
// memory, completing its bytes on an mbarrier in shared memory.
//
// A barrier serves one phase of one block: one thread initialises it for
// one arrival (mbar_init) and arrives on it with the bytes the copies will
// bring (mbar_expect_tx), a block barrier after the init makes it visible
// to the other threads, the copies complete their bytes on it, and every
// thread spins until phase 0 completes (mbar_wait_phase0).  The two kernels
// keep their own order of these steps, since they lay out different data:
// K1 arms the barrier with every byte of a block's pairs before the block
// barrier, and a thread of each team issues its pair's copies after it;
// K12 arms it after the block barrier, and one thread issues both hulls'
// copies.
#pragma once

#include <cuda_runtime.h>

namespace gjkepa {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-B aligned) from
// device to shared memory, completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Initialise the mbarrier at `bar` for one arrival, visible to the copies.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on the mbarrier at `bar`, which then waits for `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until phase 0 of the mbarrier at `bar` completes: every byte landed.
__device__ __forceinline__ void mbar_wait_phase0(unsigned bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

}  // namespace gjkepa
