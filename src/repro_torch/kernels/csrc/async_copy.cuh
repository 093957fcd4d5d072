// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// port's pipelined kernels (lowrank_qmm.cu, paged_attention.cu).
//
// A thread issues 16-byte copies that land in shared memory while it goes
// on; `commit` closes the copies issued since the last commit into a
// group, and `wait<N>` blocks until at most N of the thread's groups are
// still in flight. A __syncthreads() after the wait makes every thread's
// landed copies visible to the whole block. That gives a ring of S stages:
// stage s+S-1 is issued while stage s is consumed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

// Copy 16 bytes from src to dst (both 16-byte aligned), or write 16 zero
// bytes to dst when `valid` is false (src is then not read, but must still
// be a valid address: pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// The same for 4 bytes (4-byte aligned), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rt
