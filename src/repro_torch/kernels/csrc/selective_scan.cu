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
// bytes of x, dt and y (201 MB in float32, 60 us at 3.35 TB/s), and about
// as much the 268 M exps: the SFU computes 16 a clock per SM, 64-72 us on
// 132 SMs at 1.755-1.98 GHz. The other instructions of a step compete with
// the exps for issue, so the design spends as few as it can around each.
// At decode (T 1) the launch and the 4 MB of state in and out are all.
//
// Design:
//  * one thread per (b, c), holding its N states and its row of A * log2(e)
//    in registers; a block takes kThreads neighbouring channels of one
//    batch row (the prefill: 4 x 128 blocks). y_t is the dot product with
//    C_t in two accumulators (even and odd n), summed in a fixed order;
//  * exp(dt A) is exp2(dt * (A log2 e)), one MUFU.EX2 (ex2.approx.ftz; the
//    denormals it flushes are far below the 2e-4 tolerance), where expf
//    took ~8 instructions around it;
//  * time is walked in chunks of kChunk steps, double-buffered in shared
//    memory: the chunk's x and dt tiles (steps x channels) and its B and C
//    rows (steps x N) are copied with cp.async while the chunk before runs.
//    Each step's y is written over the x it was computed from, and the
//    chunk's y tile goes out as coalesced 16-byte rows. The loop over t
//    stays sequential, in the order of the JAX oracle
//    (ref.selective_scan_ref); the state between two chunks is all a later
//    backward needs to recompute a chunk;
//  * the state and A are read and written as 16-byte accesses.
// Measured on an H100 (700 W) at the prefill shape, in float32 (device
// time, variants built side by side and timed in turns): splitting each
// channel's states over 2 or 4 lanes (a shuffle for y) ran 119 and 145 us
// against 107 us for one lane: the time follows the instructions a step
// needs per exp, and one lane has the fewest (no shuffle, one load of x and
// dt for 16 exps); unrolling 2 or 8 steps instead of 4, four accumulators,
// software-pipelining the next step's loads and exps, and computing 1 or 2
// of the 16 exps on the FMA pipe by a polynomial all ran 0.3-14 us slower.
// At 2 lanes, loads alone (the compute skipped) took 72 us and compute
// alone (the loads skipped) 105 us, of which the exps only ~20%.
// The 16-byte copies need every row of x, dt, B, C, y and the state
// 16-byte aligned (as the Mamba layer gives them: B and C are column views
// of one projection's output, row stride dt_rank + 2N); anything else
// takes the scalar path, chosen at launch, which loads the same tiles
// element by element and computes the same bits.
// x, B, C and y are float32 or bfloat16 (y in x's dtype); dt, A and the
// states are float32. No atomics: every run gives the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 64;  // channels per block, one thread each
constexpr int kChunk = 32;    // time steps per chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// 2^v as one SFU instruction on the card
__device__ __forceinline__ float ex2(float v) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return exp2f(v);
#endif
}

// M consecutive values (16-byte aligned) into fp32 registers
template <int M>
__device__ __forceinline__ void row_f32(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < M / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}
template <int M>
__device__ __forceinline__ void row_f32(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int q = 0; q < M / 4; ++q) {
    const uint2 u = reinterpret_cast<const uint2*>(p)[q];
    v[4 * q] = __uint_as_float(u.x << 16);
    v[4 * q + 1] = __uint_as_float(u.x & 0xffff0000u);
    v[4 * q + 2] = __uint_as_float(u.y << 16);
    v[4 * q + 3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// one chunk's tiles; y overwrites x
template <typename T, int N>
struct Chunk {
  T x[kChunk][kThreads];
  float dt[kChunk][kThreads];
  T b[kChunk][N];
  T c[kChunk][N];
};

template <typename T>
struct Args {
  const T* x;  // (Bt, T, d) through its batch and time strides, as dt
  int64_t sx_b, sx_t;
  const float* dt;
  int64_t sdt_b, sdt_t;
  const float* A;
  const T* B;
  int64_t sb_b, sb_t;
  const T* C;
  int64_t sc_b, sc_t;
  const float* s0;
  T* y;
  float* s_out;
  int T_len, d;
};

// stage steps [t0, t0 + kChunk) of channels [c0, c0 + kThreads) into `ch`:
// 16-byte cp.async (VEC) or element by element; zeros past T and d
template <bool VEC, typename T, int N>
__device__ __forceinline__ void stage(Chunk<T, N>& ch, const Args<T>& a,
                                      int b, int c0, int t0) {
  const T* x = a.x + (int64_t)b * a.sx_b;
  const float* dt = a.dt + (int64_t)b * a.sdt_b;
  const T* Bm = a.B + (int64_t)b * a.sb_b;
  const T* Cm = a.C + (int64_t)b * a.sc_b;
  if constexpr (VEC) {
    constexpr int EX = 16 / sizeof(T);  // elements of x in 16 bytes
    constexpr int QX = kThreads / EX;   // 16-byte pieces of an x row
    constexpr int QD = kThreads / 4;    // of a dt row
    constexpr int QB = N / EX;          // of a B or C row
    for (int p = threadIdx.x; p < kChunk * QX; p += kThreads) {
      const int i = p / QX, c = c0 + (p % QX) * EX, t = t0 + i;
      const bool ok = t < a.T_len && c < a.d;
      cp_async16(&ch.x[i][c - c0], ok ? x + t * a.sx_t + c : x, ok);
    }
    for (int p = threadIdx.x; p < kChunk * QD; p += kThreads) {
      const int i = p / QD, c = c0 + (p % QD) * 4, t = t0 + i;
      const bool ok = t < a.T_len && c < a.d;
      cp_async16(&ch.dt[i][c - c0], ok ? dt + t * a.sdt_t + c : dt, ok);
    }
    for (int p = threadIdx.x; p < 2 * kChunk * QB; p += kThreads) {
      const int m = p / (kChunk * QB), r = p % (kChunk * QB);
      const int i = r / QB, n = (r % QB) * EX, t = t0 + i;
      const bool ok = t < a.T_len;
      const T* src = m ? Cm + t * a.sc_t + n : Bm + t * a.sb_t + n;
      cp_async16(m ? &ch.c[i][n] : &ch.b[i][n], ok ? src : Bm, ok);
    }
  } else {
    for (int p = threadIdx.x; p < kChunk * kThreads; p += kThreads) {
      const int i = p / kThreads, j = p % kThreads, t = t0 + i;
      const bool ok = t < a.T_len && c0 + j < a.d;
      ch.x[i][j] = ok ? x[t * a.sx_t + c0 + j] : T{};
      ch.dt[i][j] = ok ? dt[t * a.sdt_t + c0 + j] : 0.f;
    }
    for (int p = threadIdx.x; p < 2 * kChunk * N; p += kThreads) {
      const int m = p / (kChunk * N), r = p % (kChunk * N);
      const int i = r / N, n = r % N, t = t0 + i;
      const bool ok = t < a.T_len;
      const T v = !ok ? T{} : m ? Cm[t * a.sc_t + n] : Bm[t * a.sb_t + n];
      (m ? ch.c : ch.b)[i][n] = v;
    }
  }
}

// M floats at p, as 16-byte loads where VEC
template <bool VEC, int M>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (VEC) {
    row_f32<M>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) v[q] = p[q];
  }
}
template <bool VEC, int M>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) p[q] = v[q];
  }
}

// the 4 blocks an SM (the prefill's 512 blocks on 132 SMs) change ptxas's
// schedule, not its register cap: bf16 ran 113 us with it, 128 without
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(const Args<T> a) {
  static_assert(N % 4 == 0, "states in whole 16-byte groups");
  __shared__ __align__(16) Chunk<T, N> buf[2];
  const int ch = threadIdx.x;
  const int b = blockIdx.y, c0 = blockIdx.x * kThreads, c = c0 + ch;
  const bool live = c < a.d;
  const int64_t st = ((int64_t)b * a.d + c) * N;
  float a2[N], s[N];
  if (live) {
    load_f32<VEC, N>(a.A + (int64_t)c * N, a2);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) a2[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] *= kLog2e;
  if (live && a.s0 != nullptr) {
    load_f32<VEC, N>(a.s0 + st, s);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] = 0.f;
  }

  const int chunks = (a.T_len + kChunk - 1) / kChunk;
  if (chunks > 0) stage<VEC>(buf[0], a, b, c0, 0);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    Chunk<T, N>& cur = buf[k & 1];
    const int t0 = k * kChunk, steps = min(kChunk, a.T_len - t0);
    __syncthreads();  // chunk k-1's y has left the other buffer
    if (k + 1 < chunks) stage<VEC>(buf[(k + 1) & 1], a, b, c0, t0 + kChunk);
    cp_async_commit();
    cp_async_wait<1>();  // chunk k has landed; chunk k+1 may be in flight
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < steps; ++i) {
      const float dtv = cur.dt[i][ch];
      const float dx = dtv * to_f(cur.x[i][ch]);
      float bv[N], cv[N];
      row_f32<N>(cur.b[i], bv);
      row_f32<N>(cur.c[i], cv);
      float p[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        s[n] = fmaf(s[n], ex2(dtv * a2[n]), dx * bv[n]);
        p[n & 1] = fmaf(s[n], cv[n], p[n & 1]);
      }
      store(&cur.x[i][ch], p[0] + p[1]);  // y_t over x_t, read by this thread
    }
    __syncthreads();  // the chunk's y tile is whole
    T* y = a.y + ((int64_t)b * a.T_len + t0) * a.d + c0;
    if constexpr (VEC) {
      constexpr int EX = 16 / sizeof(T), QX = kThreads / EX;
      for (int p = threadIdx.x; p < steps * QX; p += kThreads) {
        const int i = p / QX, j = (p % QX) * EX;
        if (c0 + j < a.d)
          *reinterpret_cast<uint4*>(y + (int64_t)i * a.d + j) =
              *reinterpret_cast<const uint4*>(&cur.x[i][j]);
      }
    } else {
      for (int p = threadIdx.x; p < steps * kThreads; p += kThreads) {
        const int i = p / kThreads, j = p % kThreads;
        if (c0 + j < a.d) y[(int64_t)i * a.d + j] = cur.x[i][j];
      }
    }
  }
  if (live) store_f32<VEC, N>(a.s_out + st, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
// a stride whose dimension has more than one index moves 16-byte multiples
bool step16(long long stride, int extent, int elt) {
  return extent <= 1 || (stride * elt) % 16 == 0;
}

template <typename T, int N>
int launch(const Args<T>& a, int Bt, cudaStream_t stream) {
  constexpr int e = sizeof(T);
  const bool vec =
      aligned16(a.x) && aligned16(a.dt) && aligned16(a.A) &&
      aligned16(a.B) && aligned16(a.C) && aligned16(a.y) &&
      aligned16(a.s_out) && (a.s0 == nullptr || aligned16(a.s0)) &&
      a.d % (16 / e) == 0 && (N * e) % 16 == 0 &&
      step16(a.sx_b, Bt, e) && step16(a.sx_t, a.T_len, e) &&
      step16(a.sdt_b, Bt, 4) && step16(a.sdt_t, a.T_len, 4) &&
      step16(a.sb_b, Bt, e) && step16(a.sb_t, a.T_len, e) &&
      step16(a.sc_b, Bt, e) && step16(a.sc_t, a.T_len, e);
  const dim3 grid((unsigned)((a.d + kThreads - 1) / kThreads),
                  (unsigned)Bt);
  if (vec) {
    selective_scan_kernel<T, N, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    selective_scan_kernel<T, N, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, long long sx_b, long long sx_t, const void* dt,
        long long sdt_b, long long sdt_t, const void* A, const void* Bm,
        long long sb_b, long long sb_t, const void* Cm, long long sc_b,
        long long sc_t, const void* s0, void* y, void* s_out, int Bt,
        int T_len, int d, int N, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(x),
                  sx_b,
                  sx_t,
                  static_cast<const float*>(dt),
                  sdt_b,
                  sdt_t,
                  static_cast<const float*>(A),
                  static_cast<const T*>(Bm),
                  sb_b,
                  sb_t,
                  static_cast<const T*>(Cm),
                  sc_b,
                  sc_t,
                  static_cast<const float*>(s0),
                  static_cast<T*>(y),
                  static_cast<float*>(s_out),
                  T_len,
                  d};
  if (N == 16) return launch<T, 16>(a, Bt, stream);
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
    return run<float>(x, sx_b, sx_t, dt, sdt_b, sdt_t, A, Bm, sb_b, sb_t,
                      Cm, sc_b, sc_t, s0, y, s_out, Bt, T_len, d, N, st);
  }
  if (dtype == 1) {
    return run<__nv_bfloat16>(x, sx_b, sx_t, dt, sdt_b, sdt_t, A, Bm, sb_b,
                              sb_t, Cm, sc_b, sc_t, s0, y, s_out, Bt, T_len,
                              d, N, st);
  }
  return (int)cudaErrorInvalidValue;
}
