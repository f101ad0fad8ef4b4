// cp.async copies from global to shared memory for the SAD kernels
// (csrc/refine_cost.cu, csrc/sparse_cost.cu), which gather a keypoint's
// windows: a copy does not hold the thread, so every copy of a window is in
// flight at once.

#pragma once

#include <cuda_runtime.h>

// 4 bytes at any alignment; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes, both addresses 16-byte aligned; zero-filled where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

// waits for this thread's copies; a __syncwarp() after it shows them to the warp
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
