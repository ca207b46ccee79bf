// The issue rate of mma.sync.aligned.m16n8k8 in TF32 with fp32 sums on
// one card: every warp runs `iters` rounds of 8 independent MMAs, so that
// nothing but the tensor pipe holds them. Built and timed by
// tools/k7_turns.py --mma-rate; the rate bounds K7's products
// (src/repro_torch/kernels/csrc/mla_decode.cu).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void mma_rate_kernel(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t x = __float_as_uint(1e-3f) & 0xffffe000u;
  const uint32_t a0 = x, a1 = x, a2 = x, a3 = x, b0 = x, b1 = x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// blocks x threads threads, each warp iters x 8 MMAs; out: a float a thread
extern "C" int mma_rate_launch(float* out, int iters, int blocks,
                               int threads, void* stream) {
  mma_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return (int)cudaGetLastError();
}
