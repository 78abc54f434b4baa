// cp.async copies from device memory into shared memory, and their commit
// and wait: K1's staged tile (csrc/rqs.cu), K4's weight slots
// (csrc/coupling_device.cuh) and the bf16 policy's landing ring
// (csrc/coupling_mma.cuh). A copy in flight holds no register.
#pragma once
#include <cuda_runtime.h>

namespace {

// One word (4 or 8 bytes, through L1), or zero-filled (src-size 0:
// nothing is read) where !valid.
template <typename T>
__device__ __forceinline__ void cp_word(T* dst, const T* src,
                                        bool valid = true) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"((int)sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

// One 16-byte chunk (through L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_chunk(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group this thread committed has landed
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every group but the one committed last has landed
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace
