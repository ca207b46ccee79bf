// Asynchronous 16-byte (and 4-byte) copies from global to shared memory
// (cp.async), shared by the attention tiles (attention_tiles.cuh), K6
// (selective_scan.cu) and K7 (mla_decode.cu). A CPU build of a source
// (the tests' emulator) takes the portable branches: the copy happens at
// once, commit and wait do nothing.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

namespace {

// 16 bytes from src to dst (shared memory) without passing through
// registers; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
#else
  if (valid) {
    memcpy(dst, src, 16);
  } else {
    memset(dst, 0, 16);
  }
#endif
}
// 4 bytes from src to dst (shared memory), through L1; zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
#else
  if (valid) {
    memcpy(dst, src, 4);
  } else {
    memset(dst, 0, 4);
  }
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

}  // namespace
