// K6, the Mamba (S6) selective scan for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/selective_scan.py:selective_scan (Pallas body
// `_kernel`), whose function the JAX model computes as
// repro.layers.mamba.ssm_scan_chunked (prefill) and as the one-step update
// of mamba_apply's decode branch. For each batch row b and channel c, with
// N fp32 states s[n]:
//     s_t[n] = s_{t-1}[n] * exp(dt_t * A[c, n]) + (dt_t * x_t) * B_t[n]
//     y_t    = sum_n s_t[n] * C_t[n]
// starting from s0 (or zeros), and it returns the final state as well: the
// TPU kernel starts from zeros and returns y only, while the model's
// prefill hands the final state to decode and decode steps from it.
//
// What bounds it: at the prefill shape (Bt 4, T 512, d 8192, N 16), the
// bytes of x, dt and y (201 MB in float32, 60 us at 3.35 TB/s) against
// about 8 float32 operations per (b, t, c, n), one of them an exp (268 M
// exps), which is 32 us at the 67 TFLOP/s of the CUDA cores; so bytes,
// though the exp's instruction sequence makes issue the practical limit.
// At decode (T 1) the launch and the 4 MB of state in and out are all.
//
// Design, simple first:
//  * one thread per (b, c), holding its N states and its row of A in
//    registers; consecutive threads take consecutive channels, so every
//    load of x and dt and every store of y is one coalesced segment per
//    warp. The grid is (channel blocks, batch rows);
//  * time is walked in chunks of kChunk steps. A chunk's B_t and C_t rows
//    (N values each, the same for every channel of the block) are staged
//    once in shared memory and read as broadcasts; its x and dt are loaded
//    into registers before the chunk's recurrence starts, so the chunk's
//    loads are all in flight at once;
//  * the loop over t is sequential, in the order of the JAX oracle
//    (ref.selective_scan_ref); exp is expf, not the approximate __expf,
//    so the result stays within the oracle's 2e-4 of the associative scan.
// x, B, C and y are float32 or bfloat16 (y in x's dtype); dt, A and the
// states are float32. x and dt are read through their batch and time
// strides, B and C too (on the path they are column slices of one
// projection's output, row stride dt_rank + 2N), with unit stride along
// channels and states. No atomics: every run gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps staged per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, int64_t sx_b, int64_t sx_t,
                      const float* __restrict__ dt, int64_t sdt_b,
                      int64_t sdt_t, const float* __restrict__ A,
                      const T* __restrict__ Bm, int64_t sb_b, int64_t sb_t,
                      const T* __restrict__ Cm, int64_t sc_b, int64_t sc_t,
                      const float* __restrict__ s0, T* __restrict__ y,
                      float* __restrict__ s_out, int T_len, int d) {
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < d;
  const int64_t state0 = ((int64_t)b * d + c) * N;

  float a[N], s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(int64_t)c * N + n] : 0.f;
    s[n] = (live && s0 != nullptr) ? s0[state0 + n] : 0.f;
  }
  const T* xb = x + (int64_t)b * sx_b + c;
  const float* dtb = dt + (int64_t)b * sdt_b + c;
  const T* Bb = Bm + (int64_t)b * sb_b;
  const T* Cb = Cm + (int64_t)b * sc_b;
  T* yb = y + (int64_t)b * T_len * d + c;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int steps = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk's B and C rows are consumed
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < steps) {
        bv = to_f(Bb[(int64_t)(t0 + tt) * sb_t + n]);
        cv = to_f(Cb[(int64_t)(t0 + tt) * sc_t + n]);
      }
      sB[tt][n] = bv;
      sC[tt][n] = cv;
    }
    float xr[kChunk], dr[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool ok = live && i < steps;
      xr[i] = ok ? to_f(xb[(int64_t)(t0 + i) * sx_t]) : 0.f;
      dr[i] = ok ? dtb[(int64_t)(t0 + i) * sdt_t] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < steps) {  // the same for every thread of the block
        const float dtv = dr[i];
        const float dx = dtv * xr[i];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dA = expf(dtv * a[n]);
          s[n] = s[n] * dA + dx * sB[i][n];
          acc += s[n] * sC[i][n];
        }
        if (live) store(yb + (int64_t)(t0 + i) * d, acc);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) s_out[state0 + n] = s[n];
  }
}

template <typename T, int N>
int launch(const void* x, long long sx_b, long long sx_t, const void* dt,
           long long sdt_b, long long sdt_t, const void* A, const void* Bm,
           long long sb_b, long long sb_t, const void* Cm, long long sc_b,
           long long sc_t, const void* s0, void* y, void* s_out, int Bt,
           int T_len, int d, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)Bt);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), sx_b, sx_t, static_cast<const float*>(dt),
      sdt_b, sdt_t, static_cast<const float*>(A),
      static_cast<const T*>(Bm), sb_b, sb_t, static_cast<const T*>(Cm),
      sc_b, sc_t, static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), T_len, d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* x, long long sx_b, long long sx_t,
               const void* dt, long long sdt_b, long long sdt_t,
               const void* A, const void* Bm, long long sb_b, long long sb_t,
               const void* Cm, long long sc_b, long long sc_t,
               const void* s0, void* y, void* s_out, int Bt, int T_len,
               int d, cudaStream_t stream) {
#define K6_ARGS x, sx_b, sx_t, dt, sdt_b, sdt_t, A, Bm, sb_b, sb_t, Cm, \
    sc_b, sc_t, s0, y, s_out, Bt, T_len, d, stream
  if (N == 16) return launch<T, 16>(K6_ARGS);
#undef K6_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (Bt, T, d) and dt (Bt, T, d) through (batch, time) strides, unit
// channel stride; A (d, N) contiguous fp32; B and C (Bt, T, N) through
// (batch, time) strides, unit state stride; s0 (Bt, d, N) contiguous fp32
// or null (zeros); y (Bt, T, d) contiguous in x's dtype; s_out (Bt, d, N)
// contiguous fp32. dtype (of x, B, C, y): 0 = float32, 1 = bfloat16; dt is
// float32. N is 16 (Jamba's d_state). Returns cudaGetLastError().
extern "C" int selective_scan_launch(
    const void* x, long long sx_b, long long sx_t, const void* dt,
    long long sdt_b, long long sdt_t, const void* A, const void* Bm,
    long long sb_b, long long sb_t, const void* Cm, long long sc_b,
    long long sc_t, const void* s0, void* y, void* s_out, int Bt, int T_len,
    int d, int N, int dtype, void* stream) {
  if (Bt <= 0 || d <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_n<float>(N, x, sx_b, sx_t, dt, sdt_b, sdt_t, A, Bm,
                             sb_b, sb_t, Cm, sc_b, sc_t, s0, y, s_out, Bt,
                             T_len, d, st);
  }
  if (dtype == 1) {
    return dispatch_n<__nv_bfloat16>(N, x, sx_b, sx_t, dt, sdt_b, sdt_t, A,
                                     Bm, sb_b, sb_t, Cm, sc_b, sc_t, s0, y,
                                     s_out, Bt, T_len, d, st);
  }
  return (int)cudaErrorInvalidValue;
}
