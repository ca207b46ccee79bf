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
// operations. In float32 the bound is the CUDA cores' 67 TFLOP/s.
//
// Design:
//  * forward: one block of 128 threads per (query head, batch, query tile
//    of 64 rows), the query tiles last to first, so that under a causal
//    mask the blocks with the most key tiles start first and the light
//    ones fill the tail. The block loops over key tiles of 64, for causal
//    only up to the diagonal and, with a window, only from the first tile
//    the window reaches; a skipped tile is one where every score is
//    masked, which would leave each row's (m, l, acc) bitwise unchanged.
//    Q, K and V tiles sit in shared memory as fp32 (bf16 widens on the
//    way in), rows of head_dim floats, K's 16-byte chunks swizzled by row.
//    Each thread owns 8 query rows: for them it scores 4 keys of a tile,
//    reading Q and K as float4 along head_dim (12 loads for 128 FMAs),
//    and accumulates 8 rows x head_dim / 16 output columns, reading P and
//    V as float4 (16 loads for 256 FMAs). Loads overlap the arithmetic:
//    a tile's V streams in while Q K^T runs and the next tile's K while
//    the softmax and P V run (cp.async for float32, a register stage for
//    bf16; element by element, at once, where a source row is not 16-byte
//    aligned). Row max and sum are 16-lane butterflies. The carry (m, l,
//    acc) is fp32; masked scores give p = 0 exactly. It writes the output
//    and each row's log-sum-exp (fp32) for the backward. Every call on
//    the same inputs runs the same instructions in the same order, so the
//    rematerialized forward gives the same bits;
//  * backward, three kernels: delta = rowsum(dO * O) per row; dK and dV,
//    one block per (key tile, KV head, batch) that loops over the g query
//    heads of its group and over the query tiles that see the key tile, so
//    the GQA sum stays inside the block; dQ, one block per (query tile,
//    query head, batch) that loops over the key tiles as the forward does.
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

// key tiles [lo, hi) that hold a visible key for query rows [q0, q0 + BQ)
__device__ __forceinline__ void key_tiles(int q0, int n_t, int kv_hi,
                                          int causal, int window, int* lo,
                                          int* hi) {
  int end = kv_hi;
  if (causal) end = min(end, min(q0 + BQ, n_t));
  const int beg = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = beg / BKV;
  *hi = end > beg ? (end + BKV - 1) / BKV : *lo;
}

// query tiles [lo, hi) that see a key of tile [j0, j0 + BKV)
__device__ __forceinline__ void query_tiles(int j0, int n_t, int kv_hi,
                                            int causal, int window, int* lo,
                                            int* hi) {
  *lo = causal ? j0 / BQ : 0;
  *hi = (n_t + BQ - 1) / BQ;
  if (j0 >= kv_hi) *hi = *lo;
  if (window > 0) {
    const int j_last = min(j0 + BKV, kv_hi) - 1;
    *hi = min(*hi, (j_last + window - 1) / BQ + 1);
  }
  if (*hi < *lo) *hi = *lo;
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

constexpr int kFwdThreads = 128;  // 8 x 16: ty = tid / 16, tx = tid % 16
constexpr int FR = BQ / 8;        // query rows of a thread: ty + 8 i
constexpr int FJ = BKV / 16;      // keys a thread scores: tx + 16 j

// the forward's shared memory (bytes): the Q, K and V tiles [64][HD] fp32
// and P [BQ][BKV]
template <int HD>
constexpr size_t fwd_tile_smem() {
  return sizeof(float) * (BQ * HD + 2 * BKV * HD + BQ * BKV);
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); zeros where !valid. A CPU build of this source copies at once.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
#else
  for (int c = 0; c < 4; ++c) dst[c] = valid ? src[c] : 0.f;
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

// where 16-byte chunk c (4 floats) of tile row r lives: K's chunks are
// swizzled, so that 8 lanes reading one chunk of 8 rows hit 8 bank groups
template <bool SWZ>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return SWZ ? c ^ (r & 7) : c;
}

// A tile is rows [r0, r0 + 64) of a (n_rows, HD) slice with row stride
// `stride` (rows past n_rows are 0), stored fp32 as [64][HD]. Loading it
// has two halves, so that a tile's global reads overlap other work:
// tile_issue starts it (float32: cp.async of 16-byte chunks; bfloat16:
// 16-byte loads into `reg`), tile_commit ends it (bfloat16: widen `reg`
// into the tile). Where the source is not 16-byte aligned (vec false),
// tile_commit loads element by element and tile_issue does nothing: K2
// takes any strided view with unit stride in head_dim, as its backward
// and K4 do, so a view that starts off 16 bytes is served, not refused
// (K5 needs no such path: its pools are contiguous, so every row is
// aligned where the base is).
template <typename T, int HD>
struct Tile {
  static constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int CPR = HD / E;        // 16-byte chunks a row
  static constexpr int PER = BQ * CPR / kFwdThreads;
  static constexpr int REGS = sizeof(T) == 2 ? PER : 1;
};

template <typename T, int HD, bool SWZ>
__device__ __forceinline__ void tile_issue(float* dst, const T* src,
                                           int64_t stride, int r0,
                                           int n_rows, bool vec,
                                           uint4 (&reg)[Tile<T, HD>::REGS]) {
  using L = Tile<T, HD>;
  if (!vec) return;
#pragma unroll
  for (int u = 0; u < L::PER; ++u) {
    const int e = threadIdx.x + u * kFwdThreads;
    const int r = e / L::CPR, c = e % L::CPR;
    const bool ok = r0 + r < n_rows;
    const T* p = src + (ok ? (int64_t)(r0 + r) * stride : 0) + c * L::E;
    if constexpr (sizeof(T) == 4) {
      cp_async16(dst + r * HD + chunk_at<SWZ>(r, c) * 4,
                 reinterpret_cast<const float*>(p), ok);
    } else {
      reg[u] = ok ? *reinterpret_cast<const uint4*>(p)
                  : uint4{0u, 0u, 0u, 0u};
    }
  }
}

template <typename T, int HD, bool SWZ>
__device__ __forceinline__ void tile_commit(
    float* dst, const T* src, int64_t stride, int r0, int n_rows, bool vec,
    const uint4 (&reg)[Tile<T, HD>::REGS]) {
  using L = Tile<T, HD>;
  if (!vec) {
    for (int e = threadIdx.x; e < BQ * HD; e += kFwdThreads) {
      const int r = e / HD, d = e % HD;
      dst[r * HD + chunk_at<SWZ>(r, d / 4) * 4 + d % 4] =
          r0 + r < n_rows ? to_f(src[(int64_t)(r0 + r) * stride + d]) : 0.f;
    }
    return;
  }
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int u = 0; u < L::PER; ++u) {
      const int e = threadIdx.x + u * kFwdThreads;
      const int r = e / L::CPR, c = e % L::CPR;
      const uint32_t w[4] = {reg[u].x, reg[u].y, reg[u].z, reg[u].w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // two 4-float chunks of 8 elements
        *reinterpret_cast<float4*>(dst + r * HD +
                                   chunk_at<SWZ>(r, 2 * c + h) * 4) =
            make_float4(__uint_as_float(w[2 * h] << 16),
                        __uint_as_float(w[2 * h] & 0xffff0000u),
                        __uint_as_float(w[2 * h + 1] << 16),
                        __uint_as_float(w[2 * h + 1] & 0xffff0000u));
      }
    }
  }
}

// One block of 128 threads per (query head, batch, 64-row query tile); the
// query tiles run last to first, so that under a causal mask the blocks
// with the most key tiles start first. Thread (ty, tx) owns query rows
// ty + 8 i (i < 8): their scores against keys tx + 16 j (j < 4) of a key
// tile, then their output columns 4 (tx + 16 c) .. + 3.
template <typename T, int HD>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                 int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                 int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                 int64_t v_sb, int64_t v_st, int64_t v_sh,
                 T* __restrict__ o, float* __restrict__ lse, int n_t,
                 int n_s, int nq, int nkv, int causal, int window, int kv_hi,
                 float scale, int vec) {
  constexpr int D4 = HD / 4;   // 16-byte chunks of a row
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
  uint4 reg[Tile<T, HD>::REGS];

  int lo, hi;
  key_tiles(q0, n_t, kv_hi, causal, window, &lo, &hi);
  tile_issue<T, HD, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  tile_commit<T, HD, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  if (lo < hi) {
    tile_issue<T, HD, true>(Ks, kb, k_st, lo * BKV, n_s, vec, reg);
    tile_commit<T, HD, true>(Ks, kb, k_st, lo * BKV, n_s, vec, reg);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float m[FR], l[FR];
  float4 acc[FR][NC];
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int j0 = kt * BKV;
    // V of this tile streams in while S = Q K^T is computed
    tile_issue<T, HD, false>(Vs, vb, v_st, j0, n_s, vec, reg);
    cp_async_commit();
    float s[FR][FJ];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < FJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kv[FJ];
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        const int r = tx + 16 * j;
        kv[j] = *reinterpret_cast<const float4*>(
            Ks + r * HD + chunk_at<true>(r, d4) * 4);
      }
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (ty + 8 * i) * HD + d4 * 4);
#pragma unroll
        for (int j = 0; j < FJ; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    tile_commit<T, HD, false>(Vs, vb, v_st, j0, n_s, vec, reg);
    __syncthreads();  // every thread is done with Ks
    // the next K tile streams in while the softmax and P V run
    if (kt + 1 < hi)
      tile_issue<T, HD, true>(Ks, kb, k_st, j0 + BKV, n_s, vec, reg);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const int iq = q0 + ty + 8 * i;
      bool ok[FJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        ok[j] = visible(iq, j0 + tx + 16 * j, n_t, kv_hi, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 8 * i) * BKV + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + sum16(rs);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
      m[i] = m_new;
    }
    cp_async_wait<1>();  // V has landed; the next K may be in flight
    __syncthreads();

#pragma unroll 2
    for (int k4 = 0; k4 < BKV / 4; ++k4) {
      float4 pv[FR];
#pragma unroll
      for (int i = 0; i < FR; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * BKV +
                                                 k4 * 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(
              Vs + (k4 * 4 + u) * HD + (tx + 16 * c) * 4);
#pragma unroll
        for (int i = 0; i < FR; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c].x = fmaf(p, vv[c].x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv[c].y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv[c].z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv[c].w, acc[i][c].w);
          }
        }
      }
    }
    if (kt + 1 < hi)
      tile_commit<T, HD, true>(Ks, kb, k_st, j0 + BKV, n_s, vec, reg);
    cp_async_wait<0>();
    __syncthreads();  // the next K is in; Vs and Ps are free
  }

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                      int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                      int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                      int64_t v_sb, int64_t v_st, int64_t v_sh,
                      const T* __restrict__ dout, int64_t do_sb,
                      int64_t do_st, int64_t do_sh,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int n_t, int n_s, int nq, int nkv,
                      int causal, int window, int kv_hi, float scale) {
  constexpr int HC = HD / 16;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BKV][LD]
  float* Vs = Ks + BKV * LD;     // [BKV][LD]
  float* Qs = Vs + BKV * LD;     // [BQ][LD]
  float* dOs = Qs + BQ * LD;     // [BQ][LD]
  float* Pt = dOs + BQ * LD;     // [BKV][PLD]: P transposed
  float* dSt = Pt + BKV * PLD;   // [BKV][PLD]: dS transposed
  float* lse_s = dSt + BKV * PLD;  // [BQ]
  float* del_s = lse_s + BQ;       // [BQ]
  const int j0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, HD>(Ks, LD, k + b * k_sb + hk * k_sh, k_st, j0, n_s, BKV);
  load_rows<T, HD>(Vs, LD, v + b * v_sb + hk * v_sh, v_st, j0, n_s, BKV);

  float dka[RI][HC], dva[RI][HC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c) dka[i][c] = dva[i][c] = 0.f;

  int lo, hi;
  query_tiles(j0, n_t, kv_hi, causal, window, &lo, &hi);
  for (int gi = 0; gi < g; ++gi) {
    const int hq = hk * g + gi;
    const float* lse_h = lse + ((int64_t)b * nq + hq) * n_t;
    const float* del_h = delta + ((int64_t)b * nq + hq) * n_t;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows<T, HD>(Qs, LD, q + b * q_sb + hq * q_sh, q_st, q0, n_t, BQ);
      load_rows<T, HD>(dOs, LD, dout + b * do_sb + hq * do_sh, do_st, q0,
                       n_t, BQ);
      if (threadIdx.x < BQ) {
        const int t = q0 + threadIdx.x;
        lse_s[threadIdx.x] = t < n_t ? lse_h[t] : 0.f;
        del_s[threadIdx.x] = t < n_t ? del_h[t] : 0.f;
      }
      __syncthreads();

      // rows: keys j0 + ty + 16 i; columns: queries q0 + tx + 16 jj
      float st[RI][RJ], dpt[RI][RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) st[i][jj] = dpt[i][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float ka[RI], va[RI], qb[RJ], ob[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          ka[i] = Ks[(ty + 16 * i) * LD + d];
          va[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          qb[jj] = Qs[(tx + 16 * jj) * LD + d];
          ob[jj] = dOs[(tx + 16 * jj) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int jj = 0; jj < RJ; ++jj) {
            st[i][jj] = fmaf(ka[i], qb[jj], st[i][jj]);
            dpt[i][jj] = fmaf(va[i], ob[jj], dpt[i][jj]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int jk = j0 + ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) {
          const int c = tx + 16 * jj;
          const bool ok = visible(q0 + c, jk, n_t, kv_hi, causal, window);
          const float p = ok ? expf(st[i][jj] * scale - lse_s[c]) : 0.f;
          Pt[(ty + 16 * i) * PLD + c] = p;
          dSt[(ty + 16 * i) * PLD + c] = p * (dpt[i][jj] - del_s[c]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pa[RI], sa[RI], ob[HC], qb[HC];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pa[i] = Pt[(ty + 16 * i) * PLD + qq];
          sa[i] = dSt[(ty + 16 * i) * PLD + qq];
        }
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          ob[c] = dOs[qq * LD + tx + 16 * c];
          qb[c] = Qs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            dva[i][c] = fmaf(pa[i], ob[c], dva[i][c]);
            dka[i][c] = fmaf(sa[i], qb[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= n_s) continue;
    const int64_t off = (((int64_t)b * n_s + j) * nkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      store(dk + off + tx + 16 * c, dka[i][c] * scale);
      store(dv + off + tx + 16 * c, dva[i][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                    int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                    int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                    int64_t v_sb, int64_t v_st, int64_t v_sh,
                    const T* __restrict__ dout, int64_t do_sb, int64_t do_st,
                    int64_t do_sh, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_t, int n_s, int nq, int nkv, int causal, int window,
                    int kv_hi, float scale) {
  constexpr int HC = HD / 16;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* dOs = Qs + BQ * LD;    // [BQ][LD]
  float* Ks = dOs + BQ * LD;    // [BKV][LD]
  float* Vs = Ks + BKV * LD;    // [BKV][LD]
  float* dSs = Vs + BKV * LD;   // [BQ][PLD]
  const int q0 = blockIdx.x * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (nq / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows<T, HD>(Qs, LD, q + b * q_sb + hq * q_sh, q_st, q0, n_t, BQ);
  load_rows<T, HD>(dOs, LD, dout + b * do_sb + hq * do_sh, do_st, q0, n_t,
                   BQ);
  float lse_r[RI], del_r[RI], dqa[RI][HC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    const int64_t r = ((int64_t)b * nq + hq) * n_t + t;
    lse_r[i] = t < n_t ? lse[r] : 0.f;
    del_r[i] = t < n_t ? delta[r] : 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c) dqa[i][c] = 0.f;
  }

  int lo, hi;
  key_tiles(q0, n_t, kv_hi, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();
    load_rows<T, HD>(Ks, LD, k + b * k_sb + hk * k_sh, k_st, j0, n_s, BKV);
    load_rows<T, HD>(Vs, LD, v + b * v_sb + hk * v_sh, v_st, j0, n_s, BKV);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[RI], oa[RI], kb[RJ], vb[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qa[i] = Qs[(ty + 16 * i) * LD + d];
        oa[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        kb[j] = Ks[(tx + 16 * j) * LD + d];
        vb[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int iq = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const bool ok = visible(iq, j0 + tx + 16 * j, n_t, kv_hi, causal,
                                window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * PLD + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float sa[RI], kb[HC];
#pragma unroll
      for (int i = 0; i < RI; ++i) sa[i] = dSs[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < HC; ++c) kb[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < HC; ++c) dqa[i][c] = fmaf(sa[i], kb[c], dqa[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= n_t) continue;
    T* row = dq + (((int64_t)b * n_t + t) * nq + hq) * HD;
#pragma unroll
    for (int c = 0; c < HC; ++c) store(row + tx + 16 * c, dqa[i][c] * scale);
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
  static const cudaError_t attr = allow_smem(kern, fwd_tile_smem<HD>());
  if (attr != cudaSuccess) return (int)attr;
  // 16-byte loads where every row of q, k and v starts 16-byte aligned
  constexpr long long E = 16 / sizeof(T);
  const bool vec =
      (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v)) % 16 == 0 &&
      a.q_sb % E == 0 && a.q_st % E == 0 && a.q_sh % E == 0 &&
      a.k_sb % E == 0 && a.k_st % E == 0 && a.k_sh % E == 0 &&
      a.v_sb % E == 0 && a.v_st % E == 0 && a.v_sh % E == 0;
  const dim3 grid(a.nq, a.batch, (a.n_t + BQ - 1) / BQ);
  kern<<<grid, kFwdThreads, fwd_tile_smem<HD>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<T*>(o), static_cast<float*>(lse), a.n_t, a.n_s, a.nq,
      a.nkv, a.causal, a.window, a.kv_hi, a.scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd(const Args& a, const void* o, const void* dout, long long do_sb,
        long long do_st, long long do_sh, const void* lse, void* delta,
        void* dq, void* dk, void* dv, cudaStream_t s) {
  const int64_t rows = (int64_t)a.batch * a.n_t * a.nq;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + 7) / 8), kThreads, 0,
                                  s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), do_sb, do_st,
      do_sh, static_cast<float*>(delta), a.batch, a.n_t, a.nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kdkdv = flash_bwd_dkdv_kernel<T, HD>;
  static const cudaError_t attr_kv = allow_smem(kdkdv, dkdv_smem<HD>());
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 gkv((a.n_s + BKV - 1) / BKV, a.nkv, a.batch);
  kdkdv<<<gkv, kThreads, dkdv_smem<HD>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.n_t, a.n_s, a.nq, a.nkv,
      a.causal, a.window, a.kv_hi, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto kdq = flash_bwd_dq_kernel<T, HD>;
  static const cudaError_t attr_q = allow_smem(kdq, dq_smem<HD>());
  if (attr_q != cudaSuccess) return (int)attr_q;
  const dim3 gq((a.n_t + BQ - 1) / BQ, a.nq, a.batch);
  kdq<<<gq, kThreads, dq_smem<HD>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), a.n_t, a.n_s, a.nq, a.nkv, a.causal, a.window,
      a.kv_hi, a.scale);
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

// The forward's inputs, its output o and lse, and dout (the gradient of
// o, through strides). delta is (batch, nq, n_t) fp32 scratch; dq, dk, dv
// are contiguous in the layouts of q, k, v. Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* o, const void* dout, long long do_sb, long long do_st,
    long long do_sh, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int n_t, int n_s, int nq, int nkv, int head_dim,
    int causal, int window, int kv_len, float scale, int dtype,
    void* stream) {
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  const Args a{q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
               v_sh, batch, n_t, n_s, nq, nkv, causal, window, kv_hi, scale};
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K2_DISPATCH(bwd, a, o, dout, do_sb, do_st, do_sh, lse, delta, dq,
                     dk, dv, s);
}
