// Tiles and device helpers shared by the attention kernels K2
// (flash_attention.cu) and K4 (partial_attention.cu): 256 threads as
// 16 x 16, square 64-row query and key tiles passed through shared memory
// as fp32, 4 rows and 4 score columns a thread, 16-lane row reductions,
// and the shared memory of each kernel (fwd_smem: K4's forward). K2's
// forward uses the tile sizes and reductions with its own thread layout
// and shared memory. Everything sits in an anonymous namespace: each
// source that includes it gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int BQ = 64;              // query rows per tile
constexpr int BKV = 64;             // keys per tile
constexpr int RI = BQ / 16;         // rows per thread
constexpr int RJ = BKV / 16;        // score columns per thread
constexpr int PLD = BKV + 16;       // row stride of the score tiles
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX package
static_assert(BQ == BKV, "the backward's tile loops assume square tiles");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reductions over the 16 lanes that share a row (tx = lane % 16)
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + rows) of a (n_rows, HD) slice with row stride `stride`
// into dst (row stride ld) as fp32; rows past n_rows read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int r0, int n_rows,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int gr = r0 + r;
    dst[r * ld + d] = gr < n_rows ? to_f(src[gr * stride + d]) : 0.f;
  }
}

// shared memory (bytes) of each kernel
template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * BQ * (HD + 1) + BKV * HD + BQ * PLD);
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BQ * (HD + 1) + 2 * BKV * PLD + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BQ * (HD + 1) + BQ * PLD);
}

// raise a kernel's dynamic shared memory limit; each caller keeps the
// result in a function-local static, so this runs once per kernel (and
// never inside a CUDA graph capture after the first call)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
