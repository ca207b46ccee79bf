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

// rows [t0, t0 + kChunk) of columns [c0, c0 + W) of a (T, d) matrix (src
// at its batch row, time stride s_t, unit column stride) into `tile`, by
// THREADS threads: 16-byte cp.async (VEC) or element by element; zeros
// past T and d
template <bool VEC, int THREADS, typename T, int W>
__device__ __forceinline__ void stage_rows(T (&tile)[kChunk][W], const T* src,
                                           int64_t s_t, int T_len, int d,
                                           int c0, int t0) {
  if constexpr (VEC) {
    constexpr int EX = 16 / sizeof(T);  // elements in 16 bytes
    constexpr int Q = W / EX;           // 16-byte pieces of a row
    for (int p = threadIdx.x; p < kChunk * Q; p += THREADS) {
      const int i = p / Q, c = c0 + (p % Q) * EX, t = t0 + i;
      const bool ok = t < T_len && c < d;
      cp_async16(&tile[i][c - c0], ok ? src + t * s_t + c : src, ok);
    }
  } else {
    for (int p = threadIdx.x; p < kChunk * W; p += THREADS) {
      const int i = p / W, j = p % W, t = t0 + i;
      tile[i][j] = t < T_len && c0 + j < d ? src[t * s_t + c0 + j] : T{};
    }
  }
}

// stage steps [t0, t0 + kChunk) of channels [c0, c0 + kThreads) into `ch`
template <bool VEC, typename T, int N>
__device__ __forceinline__ void stage(Chunk<T, N>& ch, const Args<T>& a,
                                      int b, int c0, int t0) {
  stage_rows<VEC, kThreads>(ch.x, a.x + (int64_t)b * a.sx_b, a.sx_t, a.T_len,
                            a.d, c0, t0);
  stage_rows<VEC, kThreads>(ch.dt, a.dt + (int64_t)b * a.sdt_b, a.sdt_t,
                            a.T_len, a.d, c0, t0);
  stage_rows<VEC, kThreads>(ch.b, a.B + (int64_t)b * a.sb_b, a.sb_t, a.T_len,
                            N, 0, t0);
  stage_rows<VEC, kThreads>(ch.c, a.C + (int64_t)b * a.sc_b, a.sc_t, a.T_len,
                            N, 0, t0);
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
// with a_t = exp(dt_t A).
//
// What bounds it: the function moves 186 MB at the training shape of a
// microbatch (Bt 2, T 512, d 8192, N 16, float32; 55 us at 3.35 TB/s),
// but a walk back needs each step's state, which only a walk forward from
// the forward's saved chunk state (s_chunks, every 32 steps) gives, and
// dB_t and dC_t are sums over the channels of 2N terms every state-step.
// So it is bound by instructions issued: ~13 of arithmetic a state-step
// plus the states' recomputation and the channel sums.
//
// Design: the only quantity that crosses chunks going back is G, and it is
// linear. For chunk k of steps [t0, t1), with H_k = a_{t1} G_{t1} what
// enters it from above (gT, or 0, for the last):
//     G_t     = G^_t + (prod_{u=t+1}^{t1-1} a_u) H_k   (G^: the walk from 0)
//     H_{k-1} = E_k + D_k H_k,   E_k = a_{t0} G^_{t0},
//     D_k     = prod_{u=t0}^{t1-1} a_u
// and ds0 = H_{-1}. Four launches, in this order, no atomics:
//  (a) a block per (64 channels, chunk, batch row) walks G^ back through
//      its chunk's dt, dy and C tiles: E_k and D_k (the product of the a_t
//      the walk computes) into the workspace. Chunk 0's only for ds0;
//  (b) a thread per (batch row, channel, 4 states) carries H down the
//      chunks in turn, kCarry chunks' loads in flight (H_k over E_k);
//  (c) a block per (64 channels, chunk, batch row) walks G back from H_k:
//      a lane takes 4 states of two neighbouring channels, 4 lanes a
//      channel pair, 128 threads. The chunk's x, dt, dy, B, C tiles are
//      staged once (cp.async); a walk forward from s_chunks keeps each
//      lane's states at the start of each kSub-step sub-chunk in shared
//      memory; each sub-chunk, last first, is walked forward again keeping
//      its states and gates a_t in registers, then walked back. Per step a
//      lane adds its two channels' dB/dC terms, a 3-level butterfly sums
//      them over the warp's 8 channel pairs, and the lane's shares of G.B
//      and A.(G a s) go to shared memory as one 16-byte row; after each
//      sub-chunk the block sums the warps' dB/dC (one partial per step and
//      block into the workspace) and each channel's 4 shares into dx and
//      ddt, written as whole rows. dA's chunk partial goes over D_k;
//  (d) a block per (batch row, step) sums its blocks' dB/dC partials
//      (8 warps over the blocks, then in order), and a thread per (c, n)
//      dA's (batch row, chunk) partials.
// Exps: (a) one a state-step, (c) 1.875 (28 + 32 steps a chunk, none in
// the walk back): 2.81 a state-step at the training shape (378 M; the
// SFU floor 90 us at 1980 MHz). (c) runs 3 blocks of 4 warps an SM (148
// registers, 71 KB of shared memory), each lane with two channels'
// independent chains; (a) up to 40 warps (a register bound). The
// workspace: E/H and D/dA, each (Bt, chunks, d, N), and dB/dC's (Bt, T,
// d / 64, 2N): 50 MB at the training shape, dB/dC's part half of PR 31's
// per-warp 33.5 MB.
// Measured on an H100 (700 W), device time of 20 calls in a replayed CUDA
// graph, in turns with PR 31's kernel (tools/k6_bwd_turns.py): 279.0 /
// 278.8 us against 830.0 / 829.3 at the training shape (0.199 of the 55.5
// us bound), 153.1 / 150.4 against 628.4 / 628.2 at g_y = 2's 4,096
// channels (147.0-153.1 over three calls); bf16 290.7 / 291.4 and 149.1 /
// 151.0. By launch (profiler): (a) 43.7, (b) 20.0, (c) 199.6, (d) 15.2 us.
// (c) is bound by the instructions it issues: per state-step ~13 of
// arithmetic, the states walked 1.875 times, the butterfly's shuffles,
// selects and adds (without it, a wrong result, the first design ran 56 us
// faster); sharing the butterfly and the loads between two channels is
// what two channels a lane bought.
// Variants timed in turns (each row one call; the kept design last):
//  * kSub 8, 2 blocks an SM: 339.3 / 341.7 against kSub 4, 3 blocks 317.3
//    / 317.5 (one channel a lane, 256 threads; each step's G.B and A.(G a
//    s) summed over the 4 lanes by shuffles and dx, ddt stored by them);
//  * (b) as a thread per (b, c, n) loading a chunk at a time: 186 us alone,
//    against 19.9 with kCarry chunks' loads in flight;
//  * the lanes' shares through shared memory: 310.9 / 310.7 against the
//    shuffles' 317 (one call earlier); and the sums after a sub-chunk one
//    item a thread: 299.6 / 299.2 against 310.7 / 310.5;
//  * keeping each step's dt, dt x and B from the walk forward for the walk
//    back (112 registers, 2 blocks): 315.5 / 315.6 against 310.8 / 311.2;
//  * dB/dC summed through a shared-memory transpose (one add a term, 102
//    KB, 2 blocks): 341.7 / 341.3 against 299.6 / 299.0;
//  * the gates recomputed in the walk back (0.94 more exps a state-step):
//    305.0 / 304.8 against 304.7 / 304.8; at kSub 8 309.3 / 309.8;
//  * (d) as a thread per dB/dC term walking its 128 blocks: 303.9 / 304.9
//    against 299.2 / 301.3;
//  * two channels a lane (161 registers, 12 warps an SM): 285.7 / 286.0
//    against one channel's 301.0 / 300.9; with the gates recomputed 293.7
//    / 294.3; the shares as one 16-byte row (kept): 278.1 / 277.8 against
//    286.7 / 286.5;
//  * the step's two channels of dt, x and dy loaded as one access, or the
//    walk to the sub-chunk starts unrolled whole: 281.6 / 280.2 and 280.2
//    / 280.0 against 280.9 / 280.1.

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kQ = 4;                         // states per lane
constexpr int kBwdCh = 64;                    // channels per block
constexpr int kChunkThreads = kBwdCh * kLanes;  // (a)'s block: 256
constexpr int kPair = 2;                      // (c): channels per lane
constexpr int kMainThreads = kChunkThreads / kPair;  // (c)'s block: 128
constexpr int kMainWarps = kMainThreads / 32;
constexpr int kSub = 4;                       // steps a walk keeps states of
constexpr int kSubs = kChunk / kSub;          // sub-chunks in a chunk
constexpr float kLn2 = 0.6931471805599453f;

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
  float* ws_h;           // (Bt, chunks, d, N): E_k, then the carry H_k
  float* ws_d;           // (Bt, chunks, d, N): D_k, then dA's chunk partials
  float* ws_bc;          // (Bt, T, groups, 2N): dB's and dC's block partials
  int groups;            // blocks of kBwdCh channels
};

// pass (a)'s tiles: dt, dy and C of one chunk
template <typename T, int N>
struct CarryTile {
  float dt[kChunk][kBwdCh];
  T dy[kChunk][kBwdCh];
  T c[kChunk][N];
};

// pass (c)'s: the chunk's tiles, each lane's states at each sub-chunk's
// start, and of a sub-chunk's steps the warps' dB/dC sums and each lane's
// shares of G.B and A.(G a s) (a lane's two channels side by side; the 4
// padding columns keep its 16-byte stores off each other's banks)
template <typename T, int N>
struct BwdTile {
  T x[kChunk][kBwdCh];
  float dt[kChunk][kBwdCh];
  T dy[kChunk][kBwdCh];
  T b[kChunk][N];
  T c[kChunk][N];
  float bnd[kSubs][kMainThreads][kPair][kQ];
  float red[kSub][kMainWarps][2 * N];
  float2 gq[kSub][kLanes][kBwdCh + 4];
};

// v[0..7] (a lane's 2 kQ terms) summed over the warp's 8 channel pairs (lane
// bits 2-4): halve the terms at each of 3 levels, keeping the half the
// lane's bit picks; lane l is left with the sum of term l >> 2
__device__ __forceinline__ float reduce_scatter_channels(float* v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lv = 0; lv < 3; ++lv) {
    const int m = 16 >> lv, h = 4 >> lv;
    const bool hi = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float keep = hi ? v[j + h] : v[j];
      const float send = hi ? v[j] : v[j + h];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0];
}

// this lane's kQ values of a (.., N) row at p, as one 16-byte load where
// VEC; zeros where !live
template <bool VEC>
__device__ __forceinline__ void load_q(const float* p, bool live, float* v) {
  if (live) {
    load_f32<VEC, kQ>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) v[q] = 0.f;
  }
}

// (a): block (channel group, chunk k0 + y, batch row) walks G back through
// its chunk from zero: E_k = a_{t0} G_{t0} and D_k = the product of the
// chunk's a_t, per (c, n) into ws_h and ws_d
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kChunkThreads)
selective_scan_bwd_chunk_kernel(const BwdArgs<T> a, int k0) {
  static_assert(N == kLanes * kQ, "kQ states in each of kLanes lanes");
  __shared__ __align__(16) CarryTile<T, N> tile;
  const Args<T>& f = a.f;
  const int h = threadIdx.x % kLanes, j = threadIdx.x / kLanes;
  const int c0 = blockIdx.x * kBwdCh, c = c0 + j;
  const int k = k0 + blockIdx.y, b = blockIdx.z, chunks = k0 + gridDim.y;
  const int t0 = k * kChunk, steps = min(kChunk, f.T_len - t0);
  const bool live = c < f.d;
  stage_rows<VEC, kChunkThreads>(tile.dt, f.dt + (int64_t)b * f.sdt_b,
                               f.sdt_t, f.T_len, f.d, c0, t0);
  stage_rows<VEC, kChunkThreads>(tile.dy, a.dy + (int64_t)b * a.sdy_b,
                               a.sdy_t, f.T_len, f.d, c0, t0);
  stage_rows<VEC, kChunkThreads>(tile.c, f.C + (int64_t)b * f.sc_b, f.sc_t,
                               f.T_len, N, 0, t0);
  cp_async_commit();
  float a2[kQ], G[kQ], an[kQ], D[kQ];
  load_q<VEC>(f.A + (int64_t)c * N + h * kQ, live, a2);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    a2[q] *= kLog2e;
    G[q] = 0.f;
    an[q] = 1.f;
    D[q] = 1.f;
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 4
  for (int i = steps - 1; i >= 0; --i) {
    const float dtv = tile.dt[i][j];
    const float dyv = to_f(tile.dy[i][j]);
    float cv[kQ];
    row_f32<kQ>(&tile.c[i][h * kQ], cv);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float at = ex2(dtv * a2[q]);
      G[q] = fmaf(an[q], G[q], dyv * cv[q]);
      D[q] *= at;
      an[q] = at;
    }
  }
  if (live) {
    const int64_t o = (((int64_t)b * chunks + k) * f.d + c) * N + h * kQ;
#pragma unroll
    for (int q = 0; q < kQ; ++q) G[q] *= an[q];
    store_f32<true, kQ>(a.ws_h + o, G);
    store_f32<true, kQ>(a.ws_d + o, D);
  }
}

// (b): thread (b, c, 4 states) carries dL/ds down the chunks in turn: H =
// gT (or 0) enters the last; H_k overwrites E_k; H_{k-1} = E_k + D_k H_k;
// ds0 = H_{-1}. The loads of kCarry chunks are issued before their carry
constexpr int kCarry = 8;

__global__ void __launch_bounds__(256)
selective_scan_bwd_carry_kernel(float* __restrict__ ws_h,
                                const float* __restrict__ ws_d,
                                const float* gT, float* ds0, int Bt,
                                int chunks, int64_t dn) {
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (p >= Bt * dn) return;
  const int64_t b = p / dn, q = p % dn;
  float H[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) H[n] = gT != nullptr ? gT[p + n] : 0.f;
  for (int k1 = chunks - 1; k1 >= 0; k1 -= kCarry) {
    float E[kCarry][4], D[kCarry][4];
#pragma unroll
    for (int i = 0; i < kCarry; ++i) {
      if (k1 - i >= 0) {
        const int64_t o = (b * chunks + k1 - i) * dn + q;
        row_f32<4>(ws_h + o, E[i]);
        row_f32<4>(ws_d + o, D[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kCarry; ++i) {
      if (k1 - i >= 0) {
        store_f32<true, 4>(ws_h + (b * chunks + k1 - i) * dn + q, H);
#pragma unroll
        for (int n = 0; n < 4; ++n) H[n] = fmaf(D[i][n], H[n], E[i][n]);
      }
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int n = 0; n < 4; ++n) ds0[p + n] = H[n];
  }
}

// one step of the forward recurrence for a lane's two channels (j, j + 1)
// and kQ states each, with the forward's arithmetic (the same bits as the
// state it computed); at gets the step's a_t
template <typename T, int N>
__device__ __forceinline__ void step_fwd(const BwdTile<T, N>& sm, int i,
                                         int j, int h,
                                         const float (&a2)[kPair][kQ],
                                         float (&s)[kPair][kQ],
                                         float (&at)[kPair][kQ]) {
  float bv[kQ];
  row_f32<kQ>(&sm.b[i][h * kQ], bv);
#pragma unroll
  for (int e = 0; e < kPair; ++e) {
    const float dtv = sm.dt[i][j + e];
    const float dx = dtv * to_f(sm.x[i][j + e]);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      at[e][q] = ex2(dtv * a2[e][q]);
      s[e][q] = fmaf(s[e][q], at[e][q], dx * bv[q]);
    }
  }
}

// (c): block (channel group, chunk, batch row) walks G back through its
// chunk from H_k, the chunk's states recomputed from the forward's
// s_chunks in kSub-step sub-chunks; a lane takes kQ states of two
// neighbouring channels, whose dB/dC terms it adds before the butterfly;
// dx and ddt of each step, dA's chunk partial into ws_d, dB's and dC's
// block partial of each step into ws_bc
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(kMainThreads, 3)
selective_scan_bwd_kernel(const BwdArgs<T> a) {
  static_assert(N == kLanes * kQ && 2 * N == 32 && kLanes == 4 &&
                kPair == 2, "a warp's 32 sums are dB's and dC's terms; a "
                "lane's shares are one 16-byte row, a channel's 4 rows");
  static_assert(kSub * 2 * N <= kMainThreads &&
                kSub * kBwdCh % kMainThreads == 0,
                "a sub-chunk's dB/dC sums are a thread each, its dx and "
                "ddt whole rounds of the block");
  extern __shared__ __align__(16) float4 scan_smem[];
  BwdTile<T, N>& sm = *reinterpret_cast<BwdTile<T, N>*>(scan_smem);
  const Args<T>& f = a.f;
  const int tid = threadIdx.x, h = tid % kLanes, j = tid / kLanes * kPair;
  const int lane = tid & 31, warp = tid / 32;
  const int c0 = blockIdx.x * kBwdCh;
  const int k = blockIdx.y, b = blockIdx.z, chunks = gridDim.y;
  const int t0 = k * kChunk, steps = min(kChunk, f.T_len - t0);
  // the block's corner of dx, ddt (step t0, channel c0) and of ws_bc
  T* dx = a.dx + ((int64_t)b * f.T_len + t0) * f.d + c0;
  float* ddt = a.ddt + ((int64_t)b * f.T_len + t0) * f.d + c0;
  float* ws_bc = a.ws_bc + ((int64_t)b * f.T_len * a.groups + blockIdx.x) *
                               (2 * N);
  stage_rows<VEC, kMainThreads>(sm.x, f.x + (int64_t)b * f.sx_b, f.sx_t,
                                f.T_len, f.d, c0, t0);
  stage_rows<VEC, kMainThreads>(sm.dt, f.dt + (int64_t)b * f.sdt_b,
                                f.sdt_t, f.T_len, f.d, c0, t0);
  stage_rows<VEC, kMainThreads>(sm.dy, a.dy + (int64_t)b * a.sdy_b,
                                a.sdy_t, f.T_len, f.d, c0, t0);
  stage_rows<VEC, kMainThreads>(sm.b, f.B + (int64_t)b * f.sb_b, f.sb_t,
                                f.T_len, N, 0, t0);
  stage_rows<VEC, kMainThreads>(sm.c, f.C + (int64_t)b * f.sc_b, f.sc_t,
                                f.T_len, N, 0, t0);
  cp_async_commit();
  float a2[kPair][kQ], G[kPair][kQ], an[kPair][kQ], dA[kPair][kQ];
  float s[kPair][kQ], at[kPair][kQ];
  int64_t o[kPair];
  bool live[kPair];
#pragma unroll
  for (int e = 0; e < kPair; ++e) {
    const int c = c0 + j + e;
    live[e] = c < f.d;
    o[e] = (((int64_t)b * chunks + k) * f.d + c) * N + h * kQ;
    load_q<VEC>(f.A + (int64_t)c * N + h * kQ, live[e], a2[e]);
    load_q<VEC>(a.ws_h + o[e], live[e], G[e]);
    load_q<VEC>(a.s_chunks + o[e], live[e], s[e]);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      a2[e][q] *= kLog2e;
      an[e][q] = 1.f;  // a_{t+1} past the chunk's last step: G starts at H_k
      dA[e][q] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the state at the start of each sub-chunk. Steps past T have dt = x =
  // dy = 0 in the tiles (a = 1, no input), so a walk may take them
  const int subs = (steps + kSub - 1) / kSub;  // sub-chunks holding steps
  for (int u = 0; u < subs; ++u) {
#pragma unroll
    for (int e = 0; e < kPair; ++e)
#pragma unroll
      for (int q = 0; q < kQ; ++q) sm.bnd[u][tid][e][q] = s[e][q];
    if (u + 1 < subs) {
#pragma unroll 2
      for (int i = u * kSub; i < (u + 1) * kSub; ++i)
        step_fwd(sm, i, j, h, a2, s, at);
    }
  }
  for (int u = subs - 1; u >= 0; --u) {
    // the sub-chunk's states (st[i] before step i, st[kSub] after its
    // last) and gates, in registers
    float st[kSub + 1][kPair][kQ], ga[kSub][kPair][kQ];
#pragma unroll
    for (int e = 0; e < kPair; ++e)
#pragma unroll
      for (int q = 0; q < kQ; ++q) st[0][e][q] = sm.bnd[u][tid][e][q];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
#pragma unroll
      for (int e = 0; e < kPair; ++e)
#pragma unroll
        for (int q = 0; q < kQ; ++q) st[i + 1][e][q] = st[i][e][q];
      step_fwd(sm, u * kSub + i, j, h, a2, st[i + 1], ga[i]);
    }
    __syncthreads();  // the last sub-chunk's sums have been read
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      const int ti = u * kSub + i;
      float bv[kQ], cv[kQ], v[2 * kQ], gbq[2 * kPair];
      row_f32<kQ>(&sm.b[ti][h * kQ], bv);
      row_f32<kQ>(&sm.c[ti][h * kQ], cv);
#pragma unroll
      for (int e = 0; e < kPair; ++e) {
        const float dtv = sm.dt[ti][j + e];
        const float uu = dtv * to_f(sm.x[ti][j + e]);
        const float dyv = to_f(sm.dy[ti][j + e]);
        float gb = 0.f, qa = 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          G[e][q] = fmaf(an[e][q], G[e][q], dyv * cv[q]);
          // dB_t's and dC_t's terms, the lane's two channels added
          v[q] = e ? fmaf(G[e][q], uu, v[q]) : G[e][q] * uu;
          v[kQ + q] = e ? fmaf(dyv, st[i + 1][e][q], v[kQ + q])
                        : dyv * st[i + 1][e][q];
          gb = fmaf(G[e][q], bv[q], gb);
          const float g = G[e][q] * ga[i][e][q] * st[i][e][q];
          qa = fmaf(a2[e][q], g, qa);
          dA[e][q] = fmaf(dtv, g, dA[e][q]);
          an[e][q] = ga[i][e][q];
        }
        gbq[2 * e] = gb;
        gbq[2 * e + 1] = qa;
      }
      *reinterpret_cast<float4*>(&sm.gq[i][h][j]) =
          make_float4(gbq[0], gbq[1], gbq[2], gbq[3]);
      const float r = reduce_scatter_channels(v);
      const int term = lane >> 2;  // of the lane's 2 kQ: dB's, then dC's
      sm.red[i][warp][(term < kQ ? 0 : N - kQ) + h * kQ + term] = r;
    }
    __syncthreads();  // the sub-chunk's shares are whole
    if (tid < kSub * 2 * N) {
      // thread (step, term): the dB/dC block partial, the warps in order
      const int i = tid / (2 * N), l = tid % (2 * N), t = t0 + u * kSub + i;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kMainWarps; ++w) acc += sm.red[i][w][l];
      if (t < f.T_len) ws_bc[(int64_t)t * a.groups * (2 * N) + l] = acc;
    }
#pragma unroll
    for (int p = tid; p < kSub * kBwdCh; p += kMainThreads) {
      // thread (step, channel): dx and ddt, its lanes' shares in order
      const int i = p / kBwdCh, jj = p % kBwdCh, ti = u * kSub + i;
      const float2 p0 = sm.gq[i][0][jj], p1 = sm.gq[i][1][jj];
      const float2 p2 = sm.gq[i][2][jj], p3 = sm.gq[i][3][jj];
      const float gb = ((p0.x + p1.x) + p2.x) + p3.x;
      const float qa = ((p0.y + p1.y) + p2.y) + p3.y;
      if (c0 + jj < f.d && t0 + ti < f.T_len) {
        const int64_t e = (int64_t)ti * f.d + jj;
        store(&dx[e], sm.dt[ti][jj] * gb);
        ddt[e] = fmaf(kLn2, qa, to_f(sm.x[ti][jj]) * gb);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPair; ++e)
    if (live[e]) store_f32<VEC, kQ>(a.ws_d + o[e], dA[e]);
}

// (d): the partials summed in a fixed order. Block `row` of the first
// Bt T sums the row's block partials: warp w the groups w, w + 8, ..., then
// warp 0 the 8 warps' sums in order, lane l into dB (l < N) or dC; each
// thread (c, n) of the blocks after it sums dA's (batch row, chunk)
// partials
constexpr int kSumWarps = 8;

template <typename T, int N>
__global__ void __launch_bounds__(kSumWarps * 32)
selective_scan_bwd_sum_kernel(const float* ws_bc, const float* ws_a, T* dB,
                              T* dC, float* dA, int64_t rows, int groups,
                              int parts, int64_t dn) {
  static_assert(2 * N == 32, "a warp's lanes are a row's dB/dC terms");
  __shared__ float part[kSumWarps][2 * N];
  const int l = threadIdx.x % 32, w = threadIdx.x / 32;
  if (blockIdx.x < rows) {
    const int64_t row = blockIdx.x;
    const float* p = ws_bc + row * groups * 2 * N + l;
    float acc = 0.f;
#pragma unroll 8
    for (int k = w; k < groups; k += kSumWarps) acc += p[(int64_t)k * 2 * N];
    part[w][l] = acc;
    __syncthreads();
    if (w == 0) {
      acc = part[0][l];
#pragma unroll
      for (int v = 1; v < kSumWarps; ++v) acc += part[v][l];
      if (l < N) {
        store(&dB[row * N + l], acc);
      } else {
        store(&dC[row * N + l - N], acc);
      }
    }
  } else {
    const int64_t q = (blockIdx.x - rows) * blockDim.x + threadIdx.x;
    if (q < dn) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < parts; ++k) acc += ws_a[(int64_t)k * dn + q];
      dA[q] = acc;
    }
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
  // the forward's conditions on the same rows, with dL/ds and the chunk
  // states read as s0 and s_chunks were
  Args<T> f = a.f;
  f.y = a.dx;
  f.s_out = a.ddt;
  f.s0 = a.gT;
  f.s_chunks = const_cast<float*>(a.s_chunks);
  const bool vec = vec_ok<T, N>(f, Bt) && aligned16(a.dy) &&
                   aligned16(a.ws_h) && aligned16(a.ws_d) &&
                   step16(a.sdy_b, Bt, e) && step16(a.sdy_t, f.T_len, e);
  const int chunks = (f.T_len + kChunk - 1) / kChunk;
  const int64_t dn = (int64_t)f.d * N;
  // (a) for the chunks whose carry is read: all but chunk 0 unless ds0 is
  const int k0 = a.ds0 != nullptr ? 0 : 1;
  const dim3 block(kChunkThreads);
  if (chunks > k0) {
    const dim3 grid((unsigned)a.groups, (unsigned)(chunks - k0),
                    (unsigned)Bt);
    if (vec) {
      selective_scan_bwd_chunk_kernel<T, N, true><<<grid, block, 0, stream>>>(
          a, k0);
    } else {
      selective_scan_bwd_chunk_kernel<T, N, false><<<grid, block, 0, stream>>>(
          a, k0);
    }
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  selective_scan_bwd_carry_kernel<<<(unsigned)((Bt * dn / 4 + 255) / 256),
                                    256, 0, stream>>>(a.ws_h, a.ws_d, a.gT,
                                                      a.ds0, Bt, chunks, dn);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (chunks > 0) {
    const dim3 grid((unsigned)a.groups, (unsigned)chunks, (unsigned)Bt);
    const dim3 block(kMainThreads);
    const int smem = (int)sizeof(BwdTile<T, N>);
    if (vec) {
      cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      selective_scan_bwd_kernel<T, N, true><<<grid, block, smem, stream>>>(a);
    } else {
      cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      selective_scan_bwd_kernel<T, N, false><<<grid, block, smem, stream>>>(a);
    }
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int64_t rows = (int64_t)Bt * f.T_len;
  constexpr int threads = kSumWarps * 32;
  const unsigned blocks = (unsigned)(rows + (dn + threads - 1) / threads);
  selective_scan_bwd_sum_kernel<T, N><<<blocks, threads, 0, stream>>>(
      a.ws_bc, a.ws_d, a.dB, a.dC, a.dA, rows, a.groups, Bt * chunks, dn);
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

int groups_of(int d) { return (d + kBwdCh - 1) / kBwdCh; }
// floats of one (Bt, chunks, d, N) array of the backward's workspace
int64_t chunk_floats(int Bt, int T_len, int d, int N) {
  return (int64_t)Bt * ((T_len + kChunk - 1) / kChunk) * d * N;
}

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

// floats of the backward's fp32 workspace: per (batch row, chunk, channel,
// state) the chunk's E_k (then its carry H_k) and D_k (then its dA
// partial), then per (batch row, step, block of channels) dB's and dC's 2N
// partials
extern "C" long long selective_scan_bwd_workspace(int Bt, int T_len, int d,
                                                  int N) {
  return 2 * chunk_floats(Bt, T_len, d, N) +
         (int64_t)Bt * T_len * groups_of(d) * 2 * N;
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
  float* ws_h = static_cast<float*>(ws);
  float* ws_d = ws_h + chunk_floats(Bt, T_len, d, N);
  float* ws_bc = ws_d + chunk_floats(Bt, T_len, d, N);
  if (dtype == 0) {
    using T = float;
    const BwdArgs<T> a{
        make_args<T>(SCAN_FWD_PASS, nullptr, nullptr, nullptr, nullptr,
                     T_len, d),
        static_cast<const float*>(s_chunks), static_cast<const T*>(dy),
        sdy_b, sdy_t, static_cast<const float*>(gT), static_cast<T*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(ds0),
        static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
        ws_h, ws_d, ws_bc, groups_of(d)};
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
        ws_h, ws_d, ws_bc, groups_of(d)};
    return launch_bwd<T, 16>(a, Bt, st);
  }
  return (int)cudaErrorInvalidValue;
}
