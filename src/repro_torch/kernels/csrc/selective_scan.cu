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
// Training also takes its backward (below the forward): the TPU has no
// such kernel, JAX differentiates the jnp scan of ssm_scan_chunked.
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
//    (ref.selective_scan_ref); for training the state before each chunk
//    is written out (s_chunks), all the backward needs to recompute a
//    chunk;
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
  float* s_chunks;  // (Bt, chunks, d, N): the state before each chunk, or null
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
    if (live && a.s_chunks != nullptr)
      store_f32<VEC, N>(
          a.s_chunks + (((int64_t)b * chunks + k) * a.d + c) * N, s);
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

// ---------------------------------------------------------------------
// The backward. With G_t = dL/ds_t (N entries per (b, c)):
//     G_t    = dy_t C_t + a_{t+1} G_{t+1}        (walked from t = T - 1)
//     dx_t   = dt_t sum_n G_t B_t
//     ddt_t  = sum_n G_t (A a_t s_{t-1} + x_t B_t)
//     dB_t   = sum_c G_t dt_t x_t,   dC_t = sum_c dy_t s_t
//     dA     = sum_b sum_t G_t dt_t a_t s_{t-1},   ds0 = a_0 G_0
// with a_t = exp(dt_t A). One thread per (b, c) again, G in registers,
// the chunks walked in reverse. A chunk's states come back from the state
// the forward saved before it: a first walk keeps the state at the start
// of each kSub-step sub-chunk in shared memory, then each sub-chunk, last
// first, is walked again keeping its kSub states before each step, and
// walked back. kSub = 8 keeps the states at 32 KB a block (two blocks an
// SM with the double-buffered tiles) for 24 + 32 more exps a chunk than
// the 32 of the walk back; all 32 states would take 128 KB and one block.
// dB and dC are sums over channels: each step's 2N terms are summed over
// the warp's 32 lanes by a butterfly that leaves lane l with the sum of
// term l (31 shuffles), written to a workspace per warp; dA's terms are
// summed over the steps in registers and written per batch row. A second
// kernel sums the workspace over warps and batch rows in a fixed order:
// no atomics, so every run gives the same bits.
// Measured on an H100 (700 W) at the training shape of a microbatch (Bt
// 2, T 512, d 8192, N 16), float32 (chip_smoke.py, device time): 853 us,
// 0.065 of the 55 us bound (bytes) and ~10x the 88 us SFU floor of its
// 369 M exps; 628 us at g_y = 2's 4,096 channels; bf16 855 us. Saving the
// chunk states costs the forward 75 -> 77 us. The grid is 256 blocks of
// two warps, two an SM: the walk back, a chain of dependent exps, FMAs
// and the 5 levels of shuffles a step, runs with 4 warps an SM to hide
// its latency. Variants built side by side and timed in turns (the same
// bits): kSub 4 ran 857-865 us against 857-867, kSub 16 (one block an
// SM, two waves) 1,198-1,200 (600 at d 4096, against 621-623), the walk
// back unrolled 2 or 8 times 858-868: the exps are not what bounds it,
// the warps an SM are. More lanes a channel (more warps, fewer terms a
// lane to shuffle) is not measured yet.

constexpr int kSub = 8;                 // steps whose states a walk keeps
constexpr int kSubs = kChunk / kSub;    // sub-chunks in a chunk
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct BwdArgs {
  Args<T> f;             // x, dt, A, B, C as the forward read them
  const float* s_chunks; // (Bt, chunks, d, N), the forward's
  const T* dy;           // (Bt, T, d) through its batch and time strides
  int64_t sdy_b, sdy_t;
  const float* gT;       // (Bt, d, N), dL/d(final state), or null
  T* dx;                 // (Bt, T, d)
  float* ddt;            // (Bt, T, d)
  float* ds0;            // (Bt, d, N), or null
  T* dB;                 // (Bt, T, N)
  T* dC;                 // (Bt, T, N)
  float* dA;             // (d, N)
  float* ws_bc;          // (Bt, T, warps, 2N)
  float* ws_a;           // (Bt, d, N)
  int warps;             // warps of channels: kWarps * blocks
};

template <typename T, int N>
struct BwdSmem {
  Chunk<T, N> buf[2];
  T dy[2][kChunk][kThreads];
  float bnd[kSubs][N][kThreads];   // the state at each sub-chunk's start
  float st[kSub][N][kThreads];     // a sub-chunk's state before each step
};

template <bool VEC, typename T>
__device__ __forceinline__ void stage_dy(T (&dy)[kChunk][kThreads],
                                         const BwdArgs<T>& a, int b, int c0,
                                         int t0) {
  const T* src = a.dy + (int64_t)b * a.sdy_b;
  const int T_len = a.f.T_len, d = a.f.d;
  if constexpr (VEC) {
    constexpr int EX = 16 / sizeof(T), QX = kThreads / EX;
    for (int p = threadIdx.x; p < kChunk * QX; p += kThreads) {
      const int i = p / QX, c = c0 + (p % QX) * EX, t = t0 + i;
      const bool ok = t < T_len && c < d;
      cp_async16(&dy[i][c - c0], ok ? src + t * a.sdy_t + c : src, ok);
    }
  } else {
    for (int p = threadIdx.x; p < kChunk * kThreads; p += kThreads) {
      const int i = p / kThreads, j = p % kThreads, t = t0 + i;
      dy[i][j] = t < T_len && c0 + j < d ? src[t * a.sdy_t + c0 + j] : T{};
    }
  }
}

// one step of the forward recurrence, with the forward's arithmetic (the
// same bits as the state it computed)
template <typename T, int N>
__device__ __forceinline__ void step_fwd(const Chunk<T, N>& cur, int i,
                                         int ch, const float* a2, float* s) {
  const float dtv = cur.dt[i][ch];
  const float dx = dtv * to_f(cur.x[i][ch]);
  float bv[N];
  row_f32<N>(cur.b[i], bv);
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = fmaf(s[n], ex2(dtv * a2[n]), dx * bv[n]);
}

// v[0..31] over the warp's lanes -> this lane's sum of term (lane): halve
// the terms at each of 5 levels, keeping the half the lane's bit picks
__device__ __forceinline__ float warp_reduce_scatter(float* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const bool hi = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float keep = hi ? v[j + h] : v[j];
      const float send = hi ? v[j] : v[j + h];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  return v[0];
}

template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const BwdArgs<T> a) {
  static_assert(2 * N == 32, "dB and dC's 2N terms are the warp's lanes");
  extern __shared__ __align__(16) float4 scan_smem[];
  BwdSmem<T, N>& sm = *reinterpret_cast<BwdSmem<T, N>*>(scan_smem);
  const Args<T>& f = a.f;
  const int ch = threadIdx.x, lane = ch & 31;
  const int b = blockIdx.y, c0 = blockIdx.x * kThreads, c = c0 + ch;
  const int warp = blockIdx.x * kWarps + ch / 32;
  const bool live = c < f.d;
  const int64_t st = ((int64_t)b * f.d + c) * N;
  float a2[N], G[N], an[N], dA[N];
  if (live) {
    load_f32<VEC, N>(f.A + (int64_t)c * N, a2);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) a2[n] = 0.f;
  }
  if (live && a.gT != nullptr) {
    load_f32<VEC, N>(a.gT + st, G);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) G[n] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] *= kLog2e;
    an[n] = 1.f;  // a_{t+1} past the last step
    dA[n] = 0.f;
  }

  const int chunks = (f.T_len + kChunk - 1) / kChunk;
  if (chunks > 0) {
    stage<VEC>(sm.buf[(chunks - 1) & 1], f, b, c0, (chunks - 1) * kChunk);
    stage_dy<VEC>(sm.dy[(chunks - 1) & 1], a, b, c0, (chunks - 1) * kChunk);
  }
  cp_async_commit();
  for (int k = chunks - 1; k >= 0; --k) {
    Chunk<T, N>& cur = sm.buf[k & 1];
    T(&dyt)[kChunk][kThreads] = sm.dy[k & 1];
    const int t0 = k * kChunk, steps = min(kChunk, f.T_len - t0);
    __syncthreads();  // chunk k+1's dx and ddt have left the other buffer
    if (k > 0) {
      stage<VEC>(sm.buf[(k - 1) & 1], f, b, c0, t0 - kChunk);
      stage_dy<VEC>(sm.dy[(k - 1) & 1], a, b, c0, t0 - kChunk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk k has landed; chunk k-1 may be in flight
    __syncthreads();

    // the state at the start of each sub-chunk, from the chunk's. Steps
    // past T have dt = x = dy = 0 in the tiles (a = 1, no input), so every
    // walk below may take all kChunk steps
    float s[N];
    if (live) {
      load_f32<VEC, N>(a.s_chunks + (((int64_t)b * chunks + k) * f.d + c) * N,
                       s);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) s[n] = 0.f;
    }
    for (int j = 0; j < kSubs; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) sm.bnd[j][n][ch] = s[n];
      if (j + 1 < kSubs) {
        for (int i = j * kSub; i < (j + 1) * kSub; ++i)
          step_fwd(cur, i, ch, a2, s);
      }
    }
    for (int j = kSubs - 1; j >= 0; --j) {
      if (j * kSub >= steps) continue;  // wholly past T: G passes as it is
#pragma unroll
      for (int n = 0; n < N; ++n) s[n] = sm.bnd[j][n][ch];
      for (int i = 0; i < kSub; ++i) {
#pragma unroll
        for (int n = 0; n < N; ++n) sm.st[i][n][ch] = s[n];
        step_fwd(cur, j * kSub + i, ch, a2, s);
      }
      for (int i = kSub - 1; i >= 0; --i) {
        const int ti = j * kSub + i;
        const float dtv = cur.dt[ti][ch];
        const float xv = to_f(cur.x[ti][ch]);
        const float dyv = to_f(dyt[ti][ch]);
        const float u = dtv * xv;
        float bv[N], cv[N], v[2 * N];
        row_f32<N>(cur.b[ti], bv);
        row_f32<N>(cur.c[ti], cv);
        float gb[2] = {0.f, 0.f}, qa[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float sp = sm.st[i][n][ch];
          const float at = ex2(dtv * a2[n]);
          const float sn = fmaf(sp, at, u * bv[n]);  // s_t, as the forward
          G[n] = fmaf(an[n], G[n], dyv * cv[n]);
          v[n] = G[n] * u;        // dB_t's term
          v[N + n] = dyv * sn;    // dC_t's term
          gb[n & 1] = fmaf(G[n], bv[n], gb[n & 1]);
          const float q = G[n] * at * sp;
          qa[n & 1] = fmaf(a2[n], q, qa[n & 1]);
          dA[n] = fmaf(dtv, q, dA[n]);
          an[n] = at;
        }
        const float g = gb[0] + gb[1];
        // dx over x and ddt over dt, read by this thread alone
        store(&cur.x[ti][ch], dtv * g);
        cur.dt[ti][ch] = fmaf(kLn2, qa[0] + qa[1], xv * g);
        const float r = warp_reduce_scatter(v);
        if (t0 + ti < f.T_len)
          a.ws_bc[(((int64_t)b * f.T_len + t0 + ti) * a.warps + warp) *
                      (2 * N) + lane] = r;
      }
    }
    __syncthreads();  // the chunk's dx and ddt tiles are whole
    T* dx = a.dx + ((int64_t)b * f.T_len + t0) * f.d + c0;
    float* ddt = a.ddt + ((int64_t)b * f.T_len + t0) * f.d + c0;
    if constexpr (VEC) {
      constexpr int EX = 16 / sizeof(T), QX = kThreads / EX;
      for (int p = threadIdx.x; p < steps * QX; p += kThreads) {
        const int i = p / QX, j = (p % QX) * EX;
        if (c0 + j < f.d)
          *reinterpret_cast<uint4*>(dx + (int64_t)i * f.d + j) =
              *reinterpret_cast<const uint4*>(&cur.x[i][j]);
      }
      constexpr int QD = kThreads / 4;
      for (int p = threadIdx.x; p < steps * QD; p += kThreads) {
        const int i = p / QD, j = (p % QD) * 4;
        if (c0 + j < f.d)
          *reinterpret_cast<float4*>(ddt + (int64_t)i * f.d + j) =
              *reinterpret_cast<const float4*>(&cur.dt[i][j]);
      }
    } else {
      for (int p = threadIdx.x; p < steps * kThreads; p += kThreads) {
        const int i = p / kThreads, j = p % kThreads;
        if (c0 + j < f.d) {
          dx[(int64_t)i * f.d + j] = cur.x[i][j];
          ddt[(int64_t)i * f.d + j] = cur.dt[i][j];
        }
      }
    }
  }
  if (live) {
    store_f32<VEC, N>(a.ws_a + st, dA);
    if (a.ds0 != nullptr) {
      float g0[N];
#pragma unroll
      for (int n = 0; n < N; ++n) g0[n] = an[n] * G[n];
      store_f32<VEC, N>(a.ds0 + st, g0);
    }
  }
}

// the workspace summed in a fixed order: thread (row, l) of a (Bt T) x 2N
// grid sums term l of the row's warps into dB (l < N) or dC; then thread
// (c, n) of d x N sums dA's batch rows
template <typename T, int N>
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum_kernel(const float* ws_bc, const float* ws_a, T* dB,
                              T* dC, float* dA, int64_t rows, int warps,
                              int Bt, int64_t dn) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < rows * 2 * N) {
    const int64_t row = p / (2 * N);
    const int l = (int)(p % (2 * N));
    const float* w = ws_bc + row * warps * 2 * N + l;
    float acc = 0.f;
    for (int k = 0; k < warps; ++k) acc += w[(int64_t)k * 2 * N];
    if (l < N) {
      store(&dB[row * N + l], acc);
    } else {
      store(&dC[row * N + l - N], acc);
    }
  } else if (p - rows * 2 * N < dn) {
    const int64_t q = p - rows * 2 * N;
    float acc = 0.f;
    for (int k = 0; k < Bt; ++k) acc += ws_a[(int64_t)k * dn + q];
    dA[q] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
// a stride whose dimension has more than one index moves 16-byte multiples
bool step16(long long stride, int extent, int elt) {
  return extent <= 1 || (stride * elt) % 16 == 0;
}

// the 16-byte path: every row the kernels read or write 16-byte aligned
template <typename T, int N>
bool vec_ok(const Args<T>& a, int Bt) {
  constexpr int e = sizeof(T);
  return aligned16(a.x) && aligned16(a.dt) && aligned16(a.A) &&
         aligned16(a.B) && aligned16(a.C) && aligned16(a.y) &&
         aligned16(a.s_out) && (a.s0 == nullptr || aligned16(a.s0)) &&
         (a.s_chunks == nullptr || aligned16(a.s_chunks)) &&
         a.d % (16 / e) == 0 && (N * e) % 16 == 0 &&
         step16(a.sx_b, Bt, e) && step16(a.sx_t, a.T_len, e) &&
         step16(a.sdt_b, Bt, 4) && step16(a.sdt_t, a.T_len, 4) &&
         step16(a.sb_b, Bt, e) && step16(a.sb_t, a.T_len, e) &&
         step16(a.sc_b, Bt, e) && step16(a.sc_t, a.T_len, e);
}

template <typename T, int N>
int launch(const Args<T>& a, int Bt, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.d + kThreads - 1) / kThreads),
                  (unsigned)Bt);
  if (vec_ok<T, N>(a, Bt)) {
    selective_scan_kernel<T, N, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    selective_scan_kernel<T, N, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T, int N>
int launch_bwd(const BwdArgs<T>& a, int Bt, cudaStream_t stream) {
  constexpr int e = sizeof(T);
  // the forward's conditions on the same rows, with dx and ddt written as
  // y and the final state were, and dL/ds and the chunk states read
  Args<T> f = a.f;
  f.y = a.dx;
  f.s_out = a.ddt;
  f.s0 = a.gT;
  f.s_chunks = const_cast<float*>(a.s_chunks);
  const bool vec = vec_ok<T, N>(f, Bt) && aligned16(a.dy) &&
                   aligned16(a.ws_a) &&
                   (a.ds0 == nullptr || aligned16(a.ds0)) &&
                   step16(a.sdy_b, Bt, e) && step16(a.sdy_t, f.T_len, e);
  const dim3 grid((unsigned)((f.d + kThreads - 1) / kThreads),
                  (unsigned)Bt);
  const int smem = (int)sizeof(BwdSmem<T, N>);
  if (vec) {
    cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    selective_scan_bwd_kernel<T, N, true><<<grid, kThreads, smem, stream>>>(
        a);
  } else {
    cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    selective_scan_bwd_kernel<T, N, false><<<grid, kThreads, smem, stream>>>(
        a);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t rows = (int64_t)Bt * f.T_len, dn = (int64_t)f.d * N;
  const unsigned blocks = (unsigned)((rows * 2 * N + dn + 255) / 256);
  selective_scan_bwd_sum_kernel<T, N><<<blocks, 256, 0, stream>>>(
      a.ws_bc, a.ws_a, a.dB, a.dC, a.dA, rows, a.warps, Bt, dn);
  return (int)cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, long long sx_b, long long sx_t,
                  const void* dt, long long sdt_b, long long sdt_t,
                  const void* A, const void* Bm, long long sb_b,
                  long long sb_t, const void* Cm, long long sc_b,
                  long long sc_t, const void* s0, void* y, void* s_out,
                  void* s_chunks, int T_len, int d) {
  return Args<T>{static_cast<const T*>(x),
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
                 static_cast<float*>(s_chunks),
                 T_len,
                 d};
}

int warps_of(int d) { return (d + kThreads - 1) / kThreads * kWarps; }

}  // namespace

#define SCAN_FWD_ARGS                                                      \
  const void *x, long long sx_b, long long sx_t, const void *dt,          \
      long long sdt_b, long long sdt_t, const void *A, const void *Bm,    \
      long long sb_b, long long sb_t, const void *Cm, long long sc_b,     \
      long long sc_t
#define SCAN_FWD_PASS \
  x, sx_b, sx_t, dt, sdt_b, sdt_t, A, Bm, sb_b, sb_t, Cm, sc_b, sc_t

// x (Bt, T, d) and dt (Bt, T, d) through (batch, time) strides, unit
// channel stride; A (d, N) contiguous fp32; B and C (Bt, T, N) through
// (batch, time) strides, unit state stride; s0 (Bt, d, N) contiguous fp32
// or null (zeros); y (Bt, T, d) contiguous in x's dtype; s_out (Bt, d, N)
// contiguous fp32; s_chunks (Bt, ceil(T / 32), d, N) contiguous fp32, the
// state before each 32-step chunk (what the backward reads), or null.
// dtype (of x, B, C, y): 0 = float32, 1 = bfloat16; dt is float32. N is 16
// (Jamba's d_state). Returns cudaGetLastError().
extern "C" int selective_scan_states_launch(SCAN_FWD_ARGS, const void* s0,
                                            void* y, void* s_out,
                                            void* s_chunks, int Bt,
                                            int T_len, int d, int N,
                                            int dtype, void* stream) {
  if (Bt <= 0 || d <= 0) return 0;
  if (N != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, 16>(
        make_args<float>(SCAN_FWD_PASS, s0, y, s_out, s_chunks, T_len, d),
        Bt, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, 16>(
        make_args<__nv_bfloat16>(SCAN_FWD_PASS, s0, y, s_out, s_chunks,
                                 T_len, d),
        Bt, st);
  }
  return (int)cudaErrorInvalidValue;
}

// floats of the backward's fp32 workspace: (Bt, T, warps, 2N) per-warp
// sums of dB's and dC's terms, then (Bt, d, N) per-row sums of dA's
extern "C" long long selective_scan_bwd_workspace(int Bt, int T_len, int d,
                                                  int N) {
  return (long long)Bt * T_len * warps_of(d) * 2 * N + (long long)Bt * d * N;
}

// The backward of selective_scan_states_launch from its s_chunks. x,
// dt, A, B, C as the forward took them; dy (Bt, T, d) in x's dtype through
// (batch, time) strides; gT (Bt, d, N) fp32, the gradient of the final
// state, or null (zeros). Writes dx (Bt, T, d) in x's dtype, ddt (Bt, T,
// d) fp32, dA (d, N) fp32, dB and dC (Bt, T, N) in x's dtype, all
// contiguous, and where ds0 is not null the gradient of s0 (Bt, d, N)
// fp32. ws: selective_scan_bwd_workspace floats. Returns
// cudaGetLastError().
extern "C" int selective_scan_bwd_launch(
    SCAN_FWD_ARGS, const void* s_chunks, const void* dy, long long sdy_b,
    long long sdy_t, const void* gT, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* ds0, void* ws, int Bt, int T_len, int d, int N,
    int dtype, void* stream) {
  if (Bt <= 0 || d <= 0) return 0;
  if (N != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_bc = static_cast<float*>(ws);
  float* ws_a = ws_bc + (int64_t)Bt * T_len * warps_of(d) * 2 * N;
  if (dtype == 0) {
    using T = float;
    const BwdArgs<T> a{
        make_args<T>(SCAN_FWD_PASS, nullptr, nullptr, nullptr, nullptr,
                     T_len, d),
        static_cast<const float*>(s_chunks), static_cast<const T*>(dy),
        sdy_b, sdy_t, static_cast<const float*>(gT), static_cast<T*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(ds0),
        static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
        ws_bc, ws_a, warps_of(d)};
    return launch_bwd<T, 16>(a, Bt, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    const BwdArgs<T> a{
        make_args<T>(SCAN_FWD_PASS, nullptr, nullptr, nullptr, nullptr,
                     T_len, d),
        static_cast<const float*>(s_chunks), static_cast<const T*>(dy),
        sdy_b, sdy_t, static_cast<const float*>(gT), static_cast<T*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(ds0),
        static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
        ws_bc, ws_a, warps_of(d)};
    return launch_bwd<T, 16>(a, Bt, st);
  }
  return (int)cudaErrorInvalidValue;
}
