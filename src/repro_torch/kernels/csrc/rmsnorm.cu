// K3, RMSNorm for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (Pallas body `_kernel`),
// and computes what repro.core.parallel.rms_norm computes at g_x = 1 and
// what repro.layers.attention._plain_rms computes for qk-norm:
//     out = x * rsqrt(sum(x^2) / full_dim + eps) * gamma
// with fp32 statistics, output in x's dtype.
//
// What bounds it: memory. It does about 4 operations per element against
// 2 x sizeof(T) bytes moved (x in, out back, gamma from cache), far below
// the card's operations-per-byte ridge, so the least time is the bytes
// of x and out over the memory rate.
//
// Design: one warp per row, eight rows per block. Lanes stride the row so
// each warp-wide load is one contiguous segment; the sum of squares is
// reduced in fp32 with a butterfly of warp shuffles, so no shared memory
// and no block barrier is needed; the row is then read a second time
// (from L1/L2, it was just touched) to write the scaled output. The two
// row widths of the serving path are 2048 (norm1/norm2/final_norm) and
// 128 (qk-norm rows, one per head).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               T* __restrict__ out, int64_t rows, int d, float full_dim,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / full_dim + eps);
  T* orow = out + row * d;
  for (int i = lane; i < d; i += 32) {
    store(orow + i, to_f(xr[i]) * r * to_f(gamma[i]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, gamma and out share it; x and out
// are (rows, d) row-major, gamma is (d,). Returns cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              long long rows, int d, float full_dim,
                              float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(kWarps * 32);
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), rows, d, full_dim, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<__nv_bfloat16*>(out), rows, d, full_dim, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
