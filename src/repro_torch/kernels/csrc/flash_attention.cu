// K2, flash attention forward and backward for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// body `_kernel`), the causal / sliding-window GQA online-softmax forward,
// whose function the JAX training path computes in jnp as
// repro.layers.attention.attn_core. For batch b, query row t, query head hq
// (KV head hq / g, g = nq / nkv):
//     out = softmax_j(q . k_j * scale, masked) @ v_j
// where key j counts when j < kv_len, j <= t (causal) and t - j < window
// (window > 0). The JAX package has no backward kernel: it differentiates
// the jnp attn_core. The backward here is new and follows FlashAttention-2:
// P is recomputed from the forward's saved log-sum-exp, with no atomics.
//
// What bounds it: at the training shape (T = 512, head_dim 128) operations.
// The forward does 4 * T * S / 2 * head_dim operations per (batch, head)
// under the causal mask against 4 (T + 2 S) head_dim elements moved, tens
// to hundreds of operations per byte; the backward 2.5 times the forward's
// operations. In float32 the bound is the CUDA cores' 67 TFLOP/s, so both
// keep the arithmetic in registers and feed it from shared memory as
// float4, several FMAs to a load.
//
// Design:
//  * forward: one block of 128 threads per (query head, batch, query tile
//    of 64 rows), the query tiles last to first, so that under a causal
//    mask the blocks with the most key tiles start first and the light
//    ones fill the tail. The block walks the key tiles of 64 that hold a
//    visible key (for causal only up to the diagonal, with a window only
//    from the first tile it reaches) with `attend` (attention_tiles.cuh):
//    Q, K and V tiles in shared memory as fp32 (bf16 widens on the way
//    in), K's 16-byte chunks swizzled by row; each thread owns 8 query
//    rows, scores 4 keys of a tile reading Q and K as float4 (12 loads for
//    128 FMAs) and accumulates 8 rows x head_dim / 16 output columns (16
//    loads for 256 FMAs); V streams in during Q K^T and the next K during
//    the softmax and P V (cp.async for float32, a register stage for bf16;
//    element by element where a row is not 16-byte aligned). It writes the
//    output and each row's log-sum-exp (fp32) for the backward. Every call
//    on the same inputs runs the same instructions in the same order, so
//    the rematerialized forward gives the same bits; 112 KB of shared
//    memory at head_dim 128, two blocks an SM;
//  * backward (FlashAttention-2's equations: P = exp(S - lse), dV = P^T dO,
//    dS = P (dO V^T - delta), dQ = dS K scale, dK = dS^T Q scale), four
//    kernels, no atomics, every sum in a fixed order, so that two calls
//    give the same bits:
//    - delta = rowsum(dO * O) per row;
//    - dK and dV: one block per (query head, batch, 32-key tile), 512 at
//      the training shape, heaviest first. A block per KV head that walked
//      its whole GQA group did 16 tile steps where the mean was 9 on 128
//      blocks, one a SM; a block per query head walks at most 8 and two
//      share an SM (106.5 KB). Each step computes S^T and dP^T (4 keys x 4
//      queries a thread, 16 float4 loads for 128 FMAs), P and dS, then
//      dV += P^T dO and dK += dS^T Q (4 keys x head_dim / 16 columns a
//      thread, 24 loads for 256 FMAs), and writes its dS tile (fp32) to a
//      workspace. With GQA each query head's dK, dV go to the workspace;
//    - the GQA sum: dK, dV of each KV head summed over its g query heads,
//      in head order;
//    - dQ: one block per (query head, batch, 64-row query tile), last to
//      first, reading its dS tiles and K back (double-staged) in key
//      order, 1 tile product. Recomputing S and dP here instead, as a
//      FlashAttention-2 dQ pass without atomics does, would cost 2 more
//      products of the 5 (S, dP, dV, dK, dQ); the dS round trip costs B *
//      nq * T * S * 4 bytes of workspace (33.5 MB at the training shape)
//      written once and read once, some 10 us of memory time.
// All inputs are read in the model's (batch, time, head, head_dim) layout
// through strides, with unit stride in head_dim: no transposes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

__device__ __forceinline__ bool visible(int iq, int jk, int n_t, int kv_hi,
                                        int causal, int window) {
  return iq < n_t && jk < kv_hi && (!causal || iq >= jk) &&
         (window <= 0 || iq - jk < window);
}

// key tiles [lo, hi) of BKT keys that hold a visible key for query rows
// [q0, q0 + BQ), q0 < n_t: exactly the tiles with a visible (query, key)
// pair, since every mask here is an interval of keys a row
template <int BKT = BKV>
__device__ __forceinline__ void key_tiles(int q0, int n_t, int kv_hi,
                                          int causal, int window, int* lo,
                                          int* hi) {
  int end = kv_hi;
  if (causal) end = min(end, min(q0 + BQ, n_t));
  const int beg = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = beg / BKT;
  *hi = end > beg ? (end + BKT - 1) / BKT : *lo;
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

constexpr int FR = BQ / 8;  // query rows of a thread: ty + 8 i

// One block of 128 threads per (query head, batch, 64-row query tile); the
// query tiles run last to first, so that under a causal mask the blocks
// with the most key tiles start first. The block walks the key tiles that
// hold a visible key (attend in attention_tiles.cuh) from an empty carry
// and writes the normalised output and each row's log-sum-exp.
template <typename T, int HD>
__global__ void __launch_bounds__(kTileThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                 int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                 int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                 int64_t v_sb, int64_t v_st, int64_t v_sh,
                 T* __restrict__ o, float* __restrict__ lse, int n_t,
                 int n_s, int nq, int nkv, int causal, int window, int kv_hi,
                 float scale, int vec) {
  constexpr int NC = HD / 64;  // output chunks of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BQ][HD]
  float* Ks = Qs + BQ * HD;     // [BKV][HD], chunks swizzled
  float* Vs = Ks + BKV * HD;    // [BKV][HD]
  float* Ps = Vs + BKV * HD;    // [BQ][BKV]
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = hq / (nq / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * q_sb + hq * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  uint4 reg[Tile<T, HD, BQ>::REGS];

  float m[FR], l[FR];
  float4 acc[FR][NC];
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int lo, hi;
  key_tiles(q0, n_t, kv_hi, causal, window, &lo, &hi);
  tile_issue<T, HD, BQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  tile_commit<T, HD, BQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  attend<T, HD, FR>(
      Qs, Ks, Vs, Ps, kb, k_st, vb, v_st, n_s, lo, hi, vec, reg, scale,
      [&](int r, int j) {
        return visible(q0 + r, j, n_t, kv_hi, causal, window);
      },
      m, l, acc);

#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int t = q0 + ty + 8 * i;
    if (t >= n_t) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * n_t + t) * nq + hq) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T* p = orow + (tx + 16 * c) * 4;
      store(p, acc[i][c].x / den);
      store(p + 1, acc[i][c].y / den);
      store(p + 2, acc[i][c].z / den);
      store(p + 3, acc[i][c].w / den);
    }
    if (tx == 0) {
      lse[((int64_t)b * nq + hq) * n_t + t] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

constexpr int BK = 32;        // keys of a dK/dV block and of a dS tile
constexpr int BI = BK / 8;    // keys of a thread: ty + 8 i
constexpr int BJ = BQ / 16;   // queries of a thread: tx + 16 j
constexpr int TLD = BQ + 16;  // row stride of the P^T / dS^T tile

// shared memory (bytes) of the dK/dV kernel: K and V [BK][HD], Q and dO
// [BQ][HD], one [BK][TLD] tile for P^T and then dS^T, lse and delta [BQ];
// 106.5 KB at head_dim 128, so that two blocks share an SM
template <int HD>
constexpr size_t dkdv_tile_smem() {
  return sizeof(float) * (2 * BK * HD + 2 * BQ * HD + BK * TLD + 2 * BQ);
}
// of the dQ kernel: K [BK][HD] and dS^T [BK][BQ], two of each
template <int HD>
constexpr size_t dq_tile_smem() {
  return sizeof(float) * 2 * (BK * HD + BK * BQ);
}

// The backward's fp32 workspace (offsets and total, in floats): delta
// (batch, nq, n_t); dS^T of every (query tile, key tile) pair, [BK][BQ]
// each, in (batch, nq, query tile, key tile) order, of which the dK/dV
// pass writes the live pairs and the dQ pass reads them; with GQA (g > 1)
// each query head's dK and dV, (batch, n_s, nq, HD) each, summed over the
// group in order by flash_bwd_sum_kernel.
struct BwdWork {
  int64_t delta, ds, dkv, total;
};
BwdWork bwd_work(int batch, int n_t, int n_s, int nq, int nkv, int hd) {
  const int64_t n_qt = (n_t + BQ - 1) / BQ, n_kt = (n_s + BK - 1) / BK;
  BwdWork w;
  w.delta = 0;
  w.ds = ((int64_t)batch * nq * n_t + 3) / 4 * 4;
  w.dkv = w.ds + (int64_t)batch * nq * n_qt * n_kt * BK * BQ;
  w.total = w.dkv + (nq > nkv ? 2 * (int64_t)batch * n_s * nq * hd : 0);
  return w;
}

// delta[b, hq, t] = sum_d dO[b, t, hq, d] * O[b, t, hq, d]; one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       int64_t do_sb, int64_t do_st, int64_t do_sh,
                       float* __restrict__ delta, int batch, int n_t,
                       int nq) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (row >= (int64_t)batch * n_t * nq) return;
  const int hq = (int)(row % nq);
  const int64_t bt = row / nq;
  const int t = (int)(bt % n_t), b = (int)(bt / n_t);
  const T* orow = o + row * HD;
  const T* drow = dout + b * do_sb + t * do_st + hq * do_sh;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[((int64_t)b * nq + hq) * n_t + t] = s;
}

// acc[i][c] += sum_q A[ty + 8 i][q] * B[q][4 (tx + 16 c) .. + 3] over the
// BQ queries of a tile: A is [BK][TLD] (P^T or dS^T), B a swizzled [BQ][HD]
// tile (dO or Q). A is read as float4 along q: 4 queries a load.
template <int HD>
__device__ __forceinline__ void accumulate_tile(float4 (&acc)[BI][HD / 64],
                                                const float* A,
                                                const float* B, int ty,
                                                int tx) {
  constexpr int NC = HD / 64;
#pragma unroll 4
  for (int q4 = 0; q4 < BQ / 4; ++q4) {
    float4 a[BI];
#pragma unroll
    for (int i = 0; i < BI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 8 * i) * TLD +
                                              q4 * 4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qq = q4 * 4 + u;
      float4 bv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        bv[c] = *reinterpret_cast<const float4*>(
            B + qq * HD + chunk_at<true>(qq, tx + 16 * c) * 4);
#pragma unroll
      for (int i = 0; i < BI; ++i) {
        const float w = u == 0 ? a[i].x : u == 1 ? a[i].y
                      : u == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c].x = fmaf(w, bv[c].x, acc[i][c].x);
          acc[i][c].y = fmaf(w, bv[c].y, acc[i][c].y);
          acc[i][c].z = fmaf(w, bv[c].z, acc[i][c].z);
          acc[i][c].w = fmaf(w, bv[c].w, acc[i][c].w);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  store(p, v.x);
  store(p + 1, v.y);
  store(p + 2, v.z);
  store(p + 3, v.w);
}

// dK and dV of one query head: one block of 128 threads per (query head,
// batch, key tile of BK = 32), the key tiles first to last (under a causal
// mask the first see the most query tiles, so the heaviest blocks start
// first). It walks the query tiles whose rows see a key of its tile: loads
// the Q and dO tiles (swizzled), computes S^T = K Q^T and dP^T = V dO^T
// (thread (ty, tx): keys ty + 8 i, queries tx + 16 j), P = exp(S scale -
// lse) and dS = P (dP - delta), zero where masked, then dV += P^T dO and
// dK += dS^T Q (keys ty + 8 i, columns 4 (tx + 16 c) .. + 3), and writes
// the dS^T tile to the workspace for the dQ pass. A pair (query tile, key
// tile) is live when key_tiles<BK> of the query tile holds the key tile,
// the same test the dQ pass uses to read it back. With g == 1 it writes dK
// and dV; with GQA its query head's share goes to the workspace.
template <typename T, int HD>
__global__ void __launch_bounds__(kTileThreads, 2)
flash_bwd_dkdv_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                      int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                      int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                      int64_t v_sb, int64_t v_st, int64_t v_sh,
                      const T* __restrict__ dout, int64_t do_sb,
                      int64_t do_st, int64_t do_sh,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ ds, float* __restrict__ dkw,
                      float* __restrict__ dvw, T* __restrict__ dk,
                      T* __restrict__ dv, int n_t, int n_s, int nq, int nkv,
                      int causal, int window, int kv_hi, float scale,
                      int vec) {
  constexpr int D4 = HD / 4;
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BK][HD]
  float* Vs = Ks + BK * HD;      // [BK][HD]
  float* Qs = Vs + BK * HD;      // [BQ][HD], chunks swizzled
  float* dOs = Qs + BQ * HD;     // [BQ][HD], chunks swizzled
  float* Ts = dOs + BQ * HD;     // [BK][TLD]: P^T, then dS^T
  float* lse_s = Ts + BK * TLD;  // [BQ]
  float* del_s = lse_s + BQ;     // [BQ]
  const int hq = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int j0 = kt * BK, g = nq / nkv, hk = hq / g;
  const int n_qt = (n_t + BQ - 1) / BQ, n_kt = gridDim.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * q_sb + hq * q_sh;
  const T* ob = dout + b * do_sb + hq * do_sh;
  const float* lse_h = lse + ((int64_t)b * nq + hq) * n_t;
  const float* del_h = delta + ((int64_t)b * nq + hq) * n_t;
  float* ds_h = ds + ((int64_t)b * nq + hq) * n_qt * n_kt * (BK * BQ);
  uint4 reg[Tile<T, HD, BQ>::REGS];

  tile_issue<T, HD, BK, false>(Ks, k + b * k_sb + hk * k_sh, k_st, j0, n_s,
                               vec, reg);
  tile_commit<T, HD, BK, false>(Ks, k + b * k_sb + hk * k_sh, k_st, j0, n_s,
                                vec, reg);
  tile_issue<T, HD, BK, false>(Vs, v + b * v_sb + hk * v_sh, v_st, j0, n_s,
                               vec, reg);
  tile_commit<T, HD, BK, false>(Vs, v + b * v_sb + hk * v_sh, v_st, j0, n_s,
                                vec, reg);

  float4 dka[BI][NC], dva[BI][NC];
#pragma unroll
  for (int i = 0; i < BI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dka[i][c] = dva[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int qt = causal ? j0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    int lo, hi;
    key_tiles<BK>(q0, n_t, kv_hi, causal, window, &lo, &hi);
    if (kt < lo || kt >= hi) continue;  // block-uniform
    __syncthreads();  // the last tile's readers of Qs, dOs and Ts are done
    tile_issue<T, HD, BQ, true>(Qs, qb, q_st, q0, n_t, vec, reg);
    tile_commit<T, HD, BQ, true>(Qs, qb, q_st, q0, n_t, vec, reg);
    tile_issue<T, HD, BQ, true>(dOs, ob, do_st, q0, n_t, vec, reg);
    tile_commit<T, HD, BQ, true>(dOs, ob, do_st, q0, n_t, vec, reg);
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      lse_s[threadIdx.x] = t < n_t ? lse_h[t] : 0.f;
      del_s[threadIdx.x] = t < n_t ? del_h[t] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[BI][BJ], dp[BI][BJ];
#pragma unroll
    for (int i = 0; i < BI; ++i)
#pragma unroll
      for (int j = 0; j < BJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kv[BI], vv[BI];
#pragma unroll
      for (int i = 0; i < BI; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(Ks + (ty + 8 * i) * HD +
                                                 d4 * 4);
        vv[i] = *reinterpret_cast<const float4*>(Vs + (ty + 8 * i) * HD +
                                                 d4 * 4);
      }
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        const int r = tx + 16 * j;
        const int off = r * HD + chunk_at<true>(r, d4) * 4;
        const float4 qv = *reinterpret_cast<const float4*>(Qs + off);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + off);
#pragma unroll
        for (int i = 0; i < BI; ++i) {
          s[i][j] = fmaf(kv[i].x, qv.x, s[i][j]);
          s[i][j] = fmaf(kv[i].y, qv.y, s[i][j]);
          s[i][j] = fmaf(kv[i].z, qv.z, s[i][j]);
          s[i][j] = fmaf(kv[i].w, qv.w, s[i][j]);
          dp[i][j] = fmaf(vv[i].x, ov.x, dp[i][j]);
          dp[i][j] = fmaf(vv[i].y, ov.y, dp[i][j]);
          dp[i][j] = fmaf(vv[i].z, ov.z, dp[i][j]);
          dp[i][j] = fmaf(vv[i].w, ov.w, dp[i][j]);
        }
      }
    }
    // P = exp(S scale - lse) into Ts; dS = P (dP - delta) stays in dp
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int c = tx + 16 * j;
      const float ls = lse_s[c], dl = del_s[c];
#pragma unroll
      for (int i = 0; i < BI; ++i) {
        const bool ok = visible(q0 + c, j0 + ty + 8 * i, n_t, kv_hi, causal,
                                window);
        const float p = ok ? expf(s[i][j] * scale - ls) : 0.f;
        Ts[(ty + 8 * i) * TLD + c] = p;
        dp[i][j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    accumulate_tile<HD>(dva, Ts, dOs, ty, tx);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BJ; ++j)
#pragma unroll
      for (int i = 0; i < BI; ++i)
        Ts[(ty + 8 * i) * TLD + tx + 16 * j] = dp[i][j];
    __syncthreads();
    accumulate_tile<HD>(dka, Ts, Qs, ty, tx);   // dK += dS^T Q
    float* dst = ds_h + ((int64_t)qt * n_kt + kt) * (BK * BQ);
    for (int e = threadIdx.x; e < BK * BQ / 4; e += kTileThreads) {
      const int r = e / (BQ / 4), c4 = e % (BQ / 4);
      *reinterpret_cast<float4*>(dst + r * BQ + c4 * 4) =
          *reinterpret_cast<const float4*>(Ts + r * TLD + c4 * 4);
    }
  }

#pragma unroll
  for (int i = 0; i < BI; ++i) {
    const int j = j0 + ty + 8 * i;
    if (j >= n_s) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = (tx + 16 * c) * 4;
      const float4 kk = make_float4(dka[i][c].x * scale, dka[i][c].y * scale,
                                    dka[i][c].z * scale, dka[i][c].w * scale);
      if (g == 1) {
        const int64_t off = (((int64_t)b * n_s + j) * nkv + hk) * HD + d;
        store4(dk + off, kk);
        store4(dv + off, dva[i][c]);
      } else {
        const int64_t off = (((int64_t)b * n_s + j) * nq + hq) * HD + d;
        *reinterpret_cast<float4*>(dkw + off) = kk;
        *reinterpret_cast<float4*>(dvw + off) = dva[i][c];
      }
    }
  }
}

// dK and dV under GQA: each (batch, key, KV head) row sums its g query
// heads' shares in head order
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_sum_kernel(const float* __restrict__ dkw,
                     const float* __restrict__ dvw, T* __restrict__ dk,
                     T* __restrict__ dv, int64_t n4, int g) {
  constexpr int D4 = HD / 4;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n4) return;
  const int64_t src = (e / D4) * g * D4 + e % D4;  // row (b, j, hk g + 0)
  const float4* pk = reinterpret_cast<const float4*>(dkw) + src;
  const float4* pv = reinterpret_cast<const float4*>(dvw) + src;
  float4 sk = pk[0], sv = pv[0];
  for (int gi = 1; gi < g; ++gi) {
    const float4 a = pk[gi * D4], c = pv[gi * D4];
    sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
    sv = make_float4(sv.x + c.x, sv.y + c.y, sv.z + c.z, sv.w + c.w);
  }
  store4(dk + e * 4, sk);
  store4(dv + e * 4, sv);
}

// dQ = scale * dS K, from the dS^T tiles the dK/dV pass wrote: one block of
// 128 threads per (query head, batch, query tile), the query tiles last to
// first (heaviest first under a causal mask), walking the live key tiles in
// order, so each row's sum runs in one fixed order. K and dS^T tiles are
// double-staged (cp.async; bf16 K through registers). Thread (ty, tx) owns
// rows 4 ty + r and 32 + 4 ty + r (r < 4), read from dS^T as two float4 a
// key, and columns 4 (tx + 16 c) .. + 3.
template <typename T, int HD>
__global__ void __launch_bounds__(kTileThreads)
flash_bwd_dq_kernel(const T* __restrict__ k, int64_t k_sb, int64_t k_st,
                    int64_t k_sh, const float* __restrict__ ds,
                    T* __restrict__ dq, int n_t, int n_s, int nq, int nkv,
                    int causal, int window, int kv_hi, float scale,
                    int vec) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [2][BK][HD]
  float* Ds = Ks + 2 * BK * HD;  // [2][BK][BQ]: dS^T
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * BQ;
  const int n_kt = (n_s + BK - 1) / BK;
  const int hk = hq / (nq / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * k_sb + hk * k_sh;
  const float* ds_q =
      ds + (((int64_t)b * nq + hq) * gridDim.z + qt) * n_kt * (BK * BQ);
  uint4 reg[Tile<T, HD, BK>::REGS];

  float4 acc[2][4][NC];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[h][r][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  int lo, hi;
  key_tiles<BK>(q0, n_t, kv_hi, causal, window, &lo, &hi);
  if (lo < hi) {
    tile_issue<T, HD, BK, false>(Ks, kb, k_st, lo * BK, n_s, vec, reg);
    tile_commit<T, HD, BK, false>(Ks, kb, k_st, lo * BK, n_s, vec, reg);
    for (int e = threadIdx.x; e < BK * BQ / 4; e += kTileThreads)
      cp_async16(Ds + 4 * e, ds_q + (int64_t)lo * (BK * BQ) + 4 * e, true);
  }
  cp_async_commit();
  for (int kt = lo; kt < hi; ++kt) {
    const int cur = (kt - lo) & 1;
    const float* Kc = Ks + cur * (BK * HD);
    const float* Dc = Ds + cur * (BK * BQ);
    float* Kn = Ks + (cur ^ 1) * (BK * HD);
    float* Dn = Ds + (cur ^ 1) * (BK * BQ);
    const bool more = kt + 1 < hi;
    if (more) {  // the next tiles stream in while this one is used
      tile_issue<T, HD, BK, false>(Kn, kb, k_st, (kt + 1) * BK, n_s, vec,
                                   reg);
      for (int e = threadIdx.x; e < BK * BQ / 4; e += kTileThreads)
        cp_async16(Dn + 4 * e, ds_q + (int64_t)(kt + 1) * (BK * BQ) + 4 * e,
                   true);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d[2] = {
          *reinterpret_cast<const float4*>(Dc + kk * BQ + 4 * ty),
          *reinterpret_cast<const float4*>(Dc + kk * BQ + 32 + 4 * ty)};
      float4 kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Kc + kk * HD +
                                                 (tx + 16 * c) * 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w = r == 0 ? d[h].x : r == 1 ? d[h].y
                        : r == 2 ? d[h].z : d[h].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[h][r][c].x = fmaf(w, kv[c].x, acc[h][r][c].x);
            acc[h][r][c].y = fmaf(w, kv[c].y, acc[h][r][c].y);
            acc[h][r][c].z = fmaf(w, kv[c].z, acc[h][r][c].z);
            acc[h][r][c].w = fmaf(w, kv[c].w, acc[h][r][c].w);
          }
        }
    }
    if (more)
      tile_commit<T, HD, BK, false>(Kn, kb, k_st, (kt + 1) * BK, n_s, vec,
                                    reg);
    __syncthreads();  // this tile's readers are done before it is reused
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = q0 + 32 * h + 4 * ty + r;
      if (t >= n_t) continue;
      T* row = dq + (((int64_t)b * n_t + t) * nq + hq) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        store4(row + (tx + 16 * c) * 4,
               make_float4(acc[h][r][c].x * scale, acc[h][r][c].y * scale,
                           acc[h][r][c].z * scale, acc[h][r][c].w * scale));
    }
}

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int batch, n_t, n_s, nq, nkv, causal, window, kv_hi;
  float scale;
};

template <typename T, int HD>
int fwd(const Args& a, void* o, void* lse, cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, HD>;
  static const cudaError_t attr = allow_smem(kern, attend_smem<HD, BQ>());
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = rows_aligned<T>(a.q, a.q_sb, a.q_st, a.q_sh) &&
                   rows_aligned<T>(a.k, a.k_sb, a.k_st, a.k_sh) &&
                   rows_aligned<T>(a.v, a.v_sb, a.v_st, a.v_sh);
  const dim3 grid(a.nq, a.batch, (a.n_t + BQ - 1) / BQ);
  kern<<<grid, kTileThreads, attend_smem<HD, BQ>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<T*>(o), static_cast<float*>(lse), a.n_t, a.n_s, a.nq,
      a.nkv, a.causal, a.window, a.kv_hi, a.scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd(const Args& a, const void* o, const void* dout, long long do_sb,
        long long do_st, long long do_sh, const void* lse, void* work,
        void* dq, void* dk, void* dv, cudaStream_t s) {
  const BwdWork w = bwd_work(a.batch, a.n_t, a.n_s, a.nq, a.nkv, HD);
  float* ws = static_cast<float*>(work);
  float* delta = ws + w.delta;
  const int g = a.nq / a.nkv;
  float* dkw = g > 1 ? ws + w.dkv : nullptr;
  float* dvw = g > 1 ? dkw + (int64_t)a.batch * a.n_s * a.nq * HD : nullptr;
  const int64_t rows = (int64_t)a.batch * a.n_t * a.nq;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + 7) / 8), kThreads, 0,
                                  s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), do_sb, do_st,
      do_sh, delta, a.batch, a.n_t, a.nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const bool vec = rows_aligned<T>(a.q, a.q_sb, a.q_st, a.q_sh) &&
                   rows_aligned<T>(a.k, a.k_sb, a.k_st, a.k_sh) &&
                   rows_aligned<T>(a.v, a.v_sb, a.v_st, a.v_sh) &&
                   rows_aligned<T>(dout, do_sb, do_st, do_sh);
  const int n_qt = (a.n_t + BQ - 1) / BQ, n_kt = (a.n_s + BK - 1) / BK;
  auto kdkdv = flash_bwd_dkdv_kernel<T, HD>;
  static const cudaError_t attr_kv = allow_smem(kdkdv, dkdv_tile_smem<HD>());
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  kdkdv<<<dim3(a.nq, a.batch, n_kt), kTileThreads, dkdv_tile_smem<HD>(),
          s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      static_cast<const float*>(lse), delta, ws + w.ds, dkw, dvw,
      static_cast<T*>(dk), static_cast<T*>(dv), a.n_t, a.n_s, a.nq, a.nkv,
      a.causal, a.window, a.kv_hi, a.scale, (int)vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (g > 1) {
    const int64_t n4 = (int64_t)a.batch * a.n_s * a.nkv * HD / 4;
    flash_bwd_sum_kernel<T, HD><<<(unsigned)((n4 + kThreads - 1) / kThreads),
                                  kThreads, 0, s>>>(
        dkw, dvw, static_cast<T*>(dk), static_cast<T*>(dv), n4, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  auto kdq = flash_bwd_dq_kernel<T, HD>;
  static const cudaError_t attr_q = allow_smem(kdq, dq_tile_smem<HD>());
  if (attr_q != cudaSuccess) return (int)attr_q;
  kdq<<<dim3(a.nq, a.batch, n_qt), kTileThreads, dq_tile_smem<HD>(), s>>>(
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh, ws + w.ds,
      static_cast<T*>(dq), a.n_t, a.n_s, a.nq, a.nkv, a.causal, a.window,
      a.kv_hi, a.scale, (int)vec);
  return (int)cudaGetLastError();
}

int check(const Args& a, int head_dim, int dtype) {
  if (a.nkv <= 0 || a.nq % a.nkv || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

#define K2_DISPATCH(FN, ...)                                              \
  (dtype == 0 ? (head_dim == 128 ? FN<float, 128>(__VA_ARGS__)            \
                                 : FN<float, 64>(__VA_ARGS__))            \
              : (head_dim == 128 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)    \
                                 : FN<__nv_bfloat16, 64>(__VA_ARGS__)))

// q (batch, n_t, nq, head_dim) and k, v (batch, n_s, nkv, head_dim) through
// their (batch, time, head) strides, unit stride in head_dim. o (batch,
// n_t, nq, head_dim) contiguous; lse (batch, nq, n_t) fp32. Keys at or
// past kv_len are masked (kv_len <= 0: none). dtype 0 = float32, 1 =
// bfloat16; head_dim 64 or 128. Returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh, void* o,
    void* lse, int batch, int n_t, int n_s, int nq, int nkv, int head_dim,
    int causal, int window, int kv_len, float scale, int dtype,
    void* stream) {
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  const Args a{q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
               v_sh, batch, n_t, n_s, nq, nkv, causal, window, kv_hi, scale};
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K2_DISPATCH(fwd, a, o, lse, s);
}

// Floats of the backward's fp32 workspace (bwd_work), for the caller to
// allocate; -1 on a shape the backward refuses.
extern "C" long long flash_attention_bwd_workspace(int batch, int n_t,
                                                   int n_s, int nq, int nkv,
                                                   int head_dim) {
  if (nkv <= 0 || nq % nkv || (head_dim != 64 && head_dim != 128)) return -1;
  return bwd_work(batch, n_t, n_s, nq, nkv, head_dim).total;
}

// The forward's inputs, its output o and lse, and dout (the gradient of
// o, through strides). work is the fp32 workspace of
// flash_attention_bwd_workspace floats, 16-byte aligned; dq, dk, dv are
// contiguous in the layouts of q, k, v. Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* o, const void* dout, long long do_sb, long long do_st,
    long long do_sh, const void* lse, void* work, void* dq, void* dk,
    void* dv, int batch, int n_t, int n_s, int nq, int nkv, int head_dim,
    int causal, int window, int kv_len, float scale, int dtype,
    void* stream) {
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  const Args a{q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
               v_sh, batch, n_t, n_s, nq, nkv, causal, window, kv_hi, scale};
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K2_DISPATCH(bwd, a, o, dout, do_sb, do_st, do_sh, lse, work, dq,
                     dk, dv, s);
}
