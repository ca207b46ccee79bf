// K3, RMSNorm for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rmsnorm.py:rmsnorm (Pallas body `_kernel`),
// and computes what repro.core.parallel.rms_norm computes and what
// repro.layers.attention._plain_rms computes for qk-norm:
//     out = x * rsqrt(ss / full_dim + eps) * gamma,  ss = sum(x^2)
// with fp32 statistics, output in x's dtype. Three entry points:
//  * rmsnorm_launch: the single pass, ss the sum over the row it is given
//    (the whole row: g_x = 1, qk-norm);
//  * rmsnorm_stats_launch: the first half, each row's fp32 ss;
//  * rmsnorm_apply_launch: the second half, given each row's ss.
// On a mesh with g_x > 1 a row is sharded over x: the caller runs the
// stats pass on its slice, psums ss over x and runs the apply pass with
// the sum, as the reference psums its sum of squares before it normalizes.
// The three share one body (the Pass template parameter), so the stats
// pass sums a row in the single pass's order and stats then apply on a
// whole row gives the single pass's bits.
//
// What bounds it: memory. It does about 4 operations per element against
// 2 x sizeof(T) bytes moved (x in, out back, gamma from cache), far below
// the card's operations-per-byte ridge, so the least time is the bytes
// of x and out over the memory rate (x alone for the stats pass). At the
// decode shapes (a few rows) it is the latency of one dependent chain:
// load, reduce, store.
//
// Design: each row is read once, into registers, with 16-byte loads where
// the rows allow them, and written from there. The layout is chosen by the
// width d, the dtype and the alignment of x, gamma and out, never by the
// number of rows, so a row gives the same bits alone (decode) as among
// thousands (prefill, training):
//  * d a multiple of 256 from 1024 to 8192 (1024 on the x-sharded mesh
//    path, 2048 and 4096 on one card), 16-byte aligned: one block of d / 8
//    threads per row, 8 elements a thread (two float4 in float32, one
//    16-byte load in bfloat16); the sum of squares goes through a warp
//    butterfly, then every thread adds the warps' partials from shared
//    memory in warp order;
//  * d = 32 V <= 256 (qk-norm's 128, head_dim 64, the x-sharded smoke
//    width 128): one warp per row, V consecutive elements a lane in one
//    load (a float4 at 128 in float32), eight rows a block, a warp
//    butterfly;
//  * any other width or alignment (head_dim 120, a view off 16 bytes): one
//    warp per row looping over it with a stride of 32, eight rows a block;
//    the row is read a second time (from L1/L2) to write the output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block of the warp and loop layouts

// which half of the norm a launch runs: both, the row's sum of squares
// only, or the scaling by a sum given from outside
enum Pass { kFull = 0, kStats = 1, kApply = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// W 32-bit words at p (aligned to min(4 W, 16) bytes) in the widest loads
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = u.x;
      w[4 * c + 1] = u.y;
      w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
  } else if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(W == 1, "1, 2 or a multiple of 4 words");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          uint4{w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]};
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = uint2{w[0], w[1]};
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// V consecutive elements of T at p as fp32, and back
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float (&f)[V]) {
  constexpr int W = V * (int)sizeof(T) / 4;
  uint32_t w[W];
  load_words<W>(p, w);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {  // two bfloat16, the first in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float (&f)[V]) {
  constexpr int W = V * (int)sizeof(T) / 4;
  uint32_t w[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
                 << 16;
    }
  }
  store_words<W>(p, w);
}

// One block of d / 8 threads per row (d = 8 * blockDim.x, 1024 <= d <=
// 8192), 8 elements a thread held in registers.
template <typename T, int P>
__global__ void __launch_bounds__(1024)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     T* __restrict__ out, const float* __restrict__ ss_in,
                     float* __restrict__ ss_out, float full_dim, float eps) {
  __shared__ float part[32];
  const int d = blockDim.x * 8, e0 = threadIdx.x * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t off = (int64_t)blockIdx.x * d + e0;
  float v[8], g[8];
  load_vals<T, 8>(x + off, v);
  if constexpr (P != kStats) load_vals<T, 8>(gamma + e0, g);
  float tot;
  if constexpr (P == kApply) {
    tot = ss_in[blockIdx.x];
  } else {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(v[i], v[i], ss);
    ss = warp_sum(ss);
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    tot = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += part[w];
  }
  if constexpr (P == kStats) {
    if (threadIdx.x == 0) ss_out[blockIdx.x] = tot;
  } else {
    const float r = rsqrtf(tot / full_dim + eps);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * r * g[i];
    store_vals<T, 8>(out + off, v);
  }
}

// One warp per row of d = 32 V, V consecutive elements a lane.
template <typename T, int V, int P>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    T* __restrict__ out, const float* __restrict__ ss_in,
                    float* __restrict__ ss_out, int64_t rows,
                    float full_dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int64_t off = row * (32 * V) + lane * V;
  float v[V], g[V];
  load_vals<T, V>(x + off, v);
  if constexpr (P != kStats) load_vals<T, V>(gamma + lane * V, g);
  float tot;
  if constexpr (P == kApply) {
    tot = ss_in[row];
  } else {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(v[i], v[i], ss);
    tot = warp_sum(ss);
  }
  if constexpr (P == kStats) {
    if (lane == 0) ss_out[row] = tot;
  } else {
    const float r = rsqrtf(tot / full_dim + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = v[i] * r * g[i];
    store_vals<T, V>(out + off, v);
  }
}

// One warp per row of any width, lanes striding it.
template <typename T, int P>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               T* __restrict__ out, const float* __restrict__ ss_in,
               float* __restrict__ ss_out, int64_t rows, int d,
               float full_dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + row * d;
  float tot;
  if constexpr (P == kApply) {
    tot = ss_in[row];
  } else {
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = to_f(xr[i]);
      ss += v * v;
    }
    tot = warp_sum(ss);
  }
  if constexpr (P == kStats) {
    if (lane == 0) ss_out[row] = tot;
  } else {
    const float r = rsqrtf(tot / full_dim + eps);
    T* orow = out + row * d;
    for (int i = lane; i < d; i += 32) {
      store(orow + i, to_f(xr[i]) * r * to_f(gamma[i]));
    }
  }
}

// the warp layout at V elements a lane, where a lane's V elements make
// whole 32-bit words
template <typename T, int V, int P>
void warp_launch(const T* x, const T* gamma, T* out, const float* ss_in,
                 float* ss_out, long long rows, float full_dim, float eps,
                 cudaStream_t s) {
  if constexpr (V * sizeof(T) >= 4) {
    rmsnorm_warp_kernel<T, V, P><<<(unsigned)((rows + kWarps - 1) / kWarps),
                                   kWarps * 32, 0, s>>>(
        x, gamma, out, ss_in, ss_out, rows, full_dim, eps);
  }
}

// Pass P over (rows, d): the layout from d, the dtype and the alignment
// of the pointers the pass reads and writes (gamma and out are null in the
// stats pass)
template <typename T, int P>
int launch(const T* x, const T* gamma, T* out, const float* ss_in,
           float* ss_out, long long rows, int d, float full_dim, float eps,
           cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(gamma) |
                         reinterpret_cast<uintptr_t>(out);
  const int v = d / 32, lane_bytes = v * (int)sizeof(T);  // warp layout
  const bool warp = d % 32 == 0 && (v == 1 || v == 2 || v == 4 || v == 8) &&
                    lane_bytes >= 4 &&
                    addr % (lane_bytes < 16 ? lane_bytes : 16) == 0;
  if (d % 256 == 0 && d >= 1024 && d <= 8192 && addr % 16 == 0) {
    rmsnorm_block_kernel<T, P><<<(unsigned)rows, d / 8, 0, s>>>(
        x, gamma, out, ss_in, ss_out, full_dim, eps);
  } else if (warp && v == 1) {
    warp_launch<T, 1, P>(x, gamma, out, ss_in, ss_out, rows, full_dim, eps,
                         s);
  } else if (warp && v == 2) {
    warp_launch<T, 2, P>(x, gamma, out, ss_in, ss_out, rows, full_dim, eps,
                         s);
  } else if (warp && v == 4) {
    warp_launch<T, 4, P>(x, gamma, out, ss_in, ss_out, rows, full_dim, eps,
                         s);
  } else if (warp && v == 8) {
    warp_launch<T, 8, P>(x, gamma, out, ss_in, ss_out, rows, full_dim, eps,
                         s);
  } else {
    rmsnorm_kernel<T, P><<<(unsigned)((rows + kWarps - 1) / kWarps),
                           kWarps * 32, 0, s>>>(x, gamma, out, ss_in, ss_out,
                                                rows, d, full_dim, eps);
  }
  return (int)cudaGetLastError();
}

template <int P>
int dispatch(const void* x, const void* gamma, void* out, const float* ss_in,
             float* ss_out, long long rows, int d, float full_dim, float eps,
             int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, P>(static_cast<const float*>(x),
                            static_cast<const float*>(gamma),
                            static_cast<float*>(out), ss_in, ss_out, rows, d,
                            full_dim, eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, P>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<__nv_bfloat16*>(out), ss_in, ss_out, rows, d, full_dim,
        eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, gamma and out share it; x and out
// are (rows, d) row-major, gamma is (d,), ss (rows,) float32. Each returns
// cudaGetLastError().
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              long long rows, int d, float full_dim,
                              float eps, int dtype, void* stream) {
  return dispatch<kFull>(x, gamma, out, nullptr, nullptr, rows, d, full_dim,
                         eps, dtype, stream);
}

// ss[row] = sum over the row of x^2, fp32
extern "C" int rmsnorm_stats_launch(const void* x, float* ss, long long rows,
                                    int d, int dtype, void* stream) {
  return dispatch<kStats>(x, nullptr, nullptr, nullptr, ss, rows, d, 1.f,
                          0.f, dtype, stream);
}

// out = x * rsqrt(ss / full_dim + eps) * gamma, ss given per row
extern "C" int rmsnorm_apply_launch(const void* x, const void* gamma,
                                    const float* ss, void* out,
                                    long long rows, int d, float full_dim,
                                    float eps, int dtype, void* stream) {
  return dispatch<kApply>(x, gamma, out, ss, nullptr, rows, d, full_dim, eps,
                          dtype, stream);
}
