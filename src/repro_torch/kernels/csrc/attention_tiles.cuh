// Tiles and device helpers shared by the attention kernels K2
// (flash_attention.cu) and K4 (partial_attention.cu), forward and backward.
// The kernels are templates over the mask: K2's `IndexMask` (positions are
// the indices) and K4's `Pos` (query row i at global position q0 + i qs,
// key j at k0 + j ks), each with the causal and window masks. 128 threads
// as 8 x 16, each owning a few rows x a few columns of a tile product in
// registers; fp32 tiles in shared memory read as float4, 16-byte chunks
// XOR-swizzled by row where 16 rows are read at once; tile loads split in
// an issue half and a commit half so that they overlap other work
// (cp.async for float32, a register stage for bfloat16). The forwards
// share their walk over key tiles (`attend`), the backwards their four
// kernels (`launch_bwd`: delta, the dK/dV pass, the GQA sum, the dQ pass),
// which differ only in where they write: K2 stores dQ, dK and dV in the
// inputs' dtype, K4 adds dQ into a chain's fp32 sum and stores dK and dV
// in fp32.
// Everything sits in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;       // the row-wise passes: delta, GQA sum
constexpr int BQ = 64;              // query rows per tile
constexpr int BKV = 64;             // keys per tile of the forwards
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX package

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

// A mask gives visible(i, j), whether query row i sees key j, and
// key_tiles<ROWS, BKT>(a, &lo, &hi), the key tiles [lo, hi) of BKT keys
// that may hold a visible key for rows [a, a + ROWS): the forwards walk
// them; in the backward they decide which (query tile, key tile) pairs the
// dK/dV pass writes a dS tile for and the dQ pass reads back, one function
// for both passes. Each row's visible keys form an interval under both
// masks, so the tiles form one interval too.

// K2's: positions are the indices; rows at or past n_t do not exist, keys
// at or past kv_hi are masked. key_tiles holds exactly the tiles with a
// visible pair.
struct IndexMask {
  int n_t, kv_hi, causal, window;

  __device__ __forceinline__ bool visible(int iq, int jk) const {
    return iq < n_t && jk < kv_hi && (!causal || iq >= jk) &&
           (window <= 0 || iq - jk < window);
  }

  template <int ROWS, int BKT>
  __device__ __forceinline__ void key_tiles(int a, int* lo, int* hi) const {
    int end = kv_hi;
    if (causal) end = min(end, min(a + ROWS, n_t));
    const int beg = window > 0 ? max(0, a - window + 1) : 0;
    *lo = beg / BKT;
    *hi = end > beg ? (end + BKT - 1) / BKT : *lo;
  }
};

// K4's: query row i at q0 + i * qs, key j at k0 + j * ks (strides >= 1, so
// positions grow with the index); rows at or past q_hi and keys at or past
// kv_hi take no part.
struct Pos {
  int q0, qs, k0, ks;
  int q_hi, kv_hi;
  int causal, window;

  __device__ __forceinline__ bool visible(int i, int j) const {
    if (i >= q_hi || j >= kv_hi) return false;
    const int iq = q0 + i * qs, jk = k0 + j * ks;
    return (!causal || iq >= jk) && (window <= 0 || iq - jk < window);
  }

  // a tile is out when its corner positions rule out every pair (its
  // first key after the last row under the causal mask, its last key a
  // window or more before the first row); both tests are monotone in the
  // tile
  template <int ROWS, int BKT>
  __device__ __forceinline__ void key_tiles(int a, int* lo, int* hi) const {
    const int b = min(a + ROWS, q_hi);
    *lo = *hi = 0;
    if (a >= b) return;
    const int q_min = q0 + a * qs, q_max = q0 + (b - 1) * qs;
    int end = kv_hi;  // keys [beg, end) pass both corner tests
    if (causal) end = q_max < k0 ? 0 : min(end, (q_max - k0) / ks + 1);
    int beg = 0;
    if (window > 0) {
      const int x = q_min - window - k0;
      beg = x < 0 ? 0 : x / ks + 1;
    }
    if (beg >= end) return;
    *lo = beg / BKT;
    *hi = (end + BKT - 1) / BKT;
  }
};

// ---------------------------------------------------------------------- //
// tiles
// ---------------------------------------------------------------------- //

constexpr int kTileThreads = 128;  // 8 x 16: ty = tid / 16, tx = tid % 16

// where 16-byte chunk c (4 floats) of tile row r lives: a swizzled tile's
// chunks are XOR-ed with the row, so that 8 lanes reading one chunk of 8
// rows hit 8 bank groups
template <bool SWZ>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return SWZ ? c ^ (r & 7) : c;
}

// A tile is rows [r0, r0 + ROWS) of a (n_rows, HD) slice with row stride
// `stride` (rows past n_rows are 0), stored fp32 as [ROWS][HD]. Loading it
// has two halves, so that a tile's global reads overlap other work:
// tile_issue starts it (float32: cp.async of 16-byte chunks; bfloat16:
// 16-byte loads into `reg`, Tile::REGS of them), tile_commit ends it
// (bfloat16: widen `reg` into the tile). Where the source is not 16-byte
// aligned (vec false), tile_commit loads element by element and tile_issue
// does nothing: K2 and K4 take any strided view with unit stride in
// head_dim, so a view that starts off 16 bytes is served, not refused (K5
// needs no such path: its pools are contiguous, so every row is aligned
// where the base is).
template <typename T, int HD, int ROWS>
struct Tile {
  static constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int CPR = HD / E;        // 16-byte chunks a row
  static constexpr int PER = ROWS * CPR / kTileThreads;
  static constexpr int REGS = sizeof(T) == 2 ? PER : 1;
  static_assert(ROWS * CPR % kTileThreads == 0, "whole chunks a thread");
};

template <typename T, int HD, int ROWS, bool SWZ>
__device__ __forceinline__ void tile_issue(float* dst, const T* src,
                                           int64_t stride, int r0,
                                           int n_rows, bool vec, uint4* reg) {
  using L = Tile<T, HD, ROWS>;
  if (!vec) return;
#pragma unroll
  for (int u = 0; u < L::PER; ++u) {
    const int e = threadIdx.x + u * kTileThreads;
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

template <typename T, int HD, int ROWS, bool SWZ>
__device__ __forceinline__ void tile_commit(float* dst, const T* src,
                                            int64_t stride, int r0,
                                            int n_rows, bool vec,
                                            const uint4* reg) {
  using L = Tile<T, HD, ROWS>;
  if (!vec) {
    for (int e = threadIdx.x; e < ROWS * HD; e += kTileThreads) {
      const int r = e / HD, d = e % HD;
      dst[r * HD + chunk_at<SWZ>(r, d / 4) * 4 + d % 4] =
          r0 + r < n_rows ? to_f(src[(int64_t)(r0 + r) * stride + d]) : 0.f;
    }
    return;
  }
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int u = 0; u < L::PER; ++u) {
      const int e = threadIdx.x + u * kTileThreads;
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

// whether every row of q, k, v (and dout) starts 16-byte aligned: the
// tiles' vector loads need it
template <typename T>
__device__ __host__ inline bool rows_aligned(const void* p, long long sb,
                                             long long st, long long sh) {
  constexpr long long E = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % E == 0 &&
         st % E == 0 && sh % E == 0;
}

// The forward's walk of one query tile over key tiles [lo, hi) of 64 keys,
// an online softmax whose fp32 carry (m, l, acc) the caller initialises and
// finishes: K2's forward starts it empty and writes the normalised output,
// K4's forward loads a chain's carry and stores it back. The caller has
// issued the query tile Qs ([8 FR][HD] fp32, rows read as float4) before
// the call; Ks is [BKV][HD] (chunks swizzled), Vs [BKV][DV], Ps [8 FR][BKV].
// HD is the width of q and k, DV that of v and the output (MLA's 192 and
// 128; every other caller DV = HD).
// Thread (ty, tx) owns query rows ty + 8 i (i < FR): their scores against
// keys tx + 16 j (j < 4) of a tile, reading Q and K as float4 along
// head_dim, then their output columns 4 (tx + 16 c) .. + 3, reading P and
// V as float4. V of a tile streams in while Q K^T runs and the next K
// while the softmax and P V run. Tile row r is query row q0 + r of P; a
// masked score gives p = 0 exactly, so a row that sees no key of a
// tile keeps its carry bit for bit (alpha = exp(0) = 1), and a tile whose
// every score is masked may be walked or skipped with the same bits.
template <typename T, int HD, int FR, typename Mask, int DV = HD>
__device__ __forceinline__ void attend(const float* Qs, float* Ks, float* Vs,
                                       float* Ps, const T* kb, int64_t k_st,
                                       const T* vb, int64_t v_st, int n_s,
                                       int lo, int hi, bool vec, uint4* reg,
                                       float scale, const Mask& P, int q0,
                                       float (&m)[FR], float (&l)[FR],
                                       float4 (&acc)[FR][DV / 64]) {
  constexpr int D4 = HD / 4;   // 16-byte chunks of a q/k row
  constexpr int NC = DV / 64;  // output chunks of a thread
  constexpr int FJ = BKV / 16; // keys a thread scores: tx + 16 j
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (lo < hi) {
    tile_issue<T, HD, BKV, true>(Ks, kb, k_st, lo * BKV, n_s, vec, reg);
    tile_commit<T, HD, BKV, true>(Ks, kb, k_st, lo * BKV, n_s, vec, reg);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int kt = lo; kt < hi; ++kt) {
    const int j0 = kt * BKV;
    // V of this tile streams in while S = Q K^T is computed
    tile_issue<T, DV, BKV, false>(Vs, vb, v_st, j0, n_s, vec, reg);
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
    tile_commit<T, DV, BKV, false>(Vs, vb, v_st, j0, n_s, vec, reg);
    __syncthreads();  // every thread is done with Ks
    // the next K tile streams in while the softmax and P V run
    if (kt + 1 < hi)
      tile_issue<T, HD, BKV, true>(Ks, kb, k_st, j0 + BKV, n_s, vec, reg);
    cp_async_commit();

#pragma unroll
    for (int i = 0; i < FR; ++i) {
      bool ok[FJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        ok[j] = P.visible(q0 + ty + 8 * i, j0 + tx + 16 * j);
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
              Vs + (k4 * 4 + u) * DV + (tx + 16 * c) * 4);
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
      tile_commit<T, HD, BKV, true>(Ks, kb, k_st, j0 + BKV, n_s, vec, reg);
    cp_async_wait<0>();
    __syncthreads();  // the next K is in; Vs and Ps are free
  }
}

// shared memory (bytes) of a forward over query tiles of ROWS rows: the Q
// tile [ROWS][HD], K [BKV][HD], V [BKV][DV] and P [ROWS][BKV], fp32
template <int HD, int ROWS, int DV = HD>
constexpr size_t attend_smem() {
  return sizeof(float) * (ROWS * HD + BKV * HD + BKV * DV + ROWS * BKV);
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

// what a launch reads: q (batch, n_t, nq, HD) and k, v (batch, n_s, nkv,
// HD) through their (batch, time, head) strides, unit stride in head_dim;
// the mask; the softmax scale
template <typename Mask>
struct Args {
  const void *q, *k, *v;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int batch, n_t, n_s, nq, nkv;
  Mask pos;
  float scale;
};

// ---------------------------------------------------------------------- //
// the backward (FlashAttention-2's equations, given each row's lse and
// delta = rowsum(dO * O): P = exp(S - lse), dV = P^T dO, dS = P (dO V^T -
// delta), dQ = dS K scale, dK = dS^T Q scale)
// ---------------------------------------------------------------------- //

constexpr int BK = 32;        // keys of a dK/dV block and of a dS tile
constexpr int BI = BK / 8;    // keys of a thread: ty + 8 i
constexpr int BJ = BQ / 16;   // queries of a thread: tx + 16 j
constexpr int TLD = BQ + 16;  // row stride of the P^T / dS^T tile

// shared memory (bytes) of the dK/dV kernel: K [BK][HD], V [BK][DV], Q
// [BQ][HD] and dO [BQ][DV], one [BK][TLD] tile for P^T and then dS^T, lse
// and delta [BQ]; 106.5 KB at head_dim 128, so that two blocks share an SM
// (130.5 KB at MLA's (192, 128): one block an SM)
template <int HD, int DV = HD>
constexpr size_t dkdv_tile_smem() {
  return sizeof(float) *
         (BK * (HD + DV) + BQ * (HD + DV) + BK * TLD + 2 * BQ);
}
// of the dQ kernel: K [BK][HD] and dS^T [BK][BQ], two of each
template <int HD>
constexpr size_t dq_tile_smem() {
  return sizeof(float) * 2 * (BK * HD + BK * BQ);
}

// The backward's fp32 workspace (offsets and total, in floats): delta
// (batch, nq, n_t) where the call computes it (K2; K4's comes from its
// chain); dS^T of every (query tile, key tile) pair, [BK][BQ] each, in
// (batch, nq, query tile, key tile) order, of which the dK/dV pass writes
// the pairs key_tiles<BQ, BK> holds and the dQ pass reads them; with GQA
// (g > 1) each query head's dK and dV, (batch, n_s, nq, HD) each, summed
// over the group in order by flash_bwd_sum_kernel.
struct BwdWork {
  int64_t delta, ds, dkv, total;
};
inline BwdWork bwd_work(int batch, int n_t, int n_s, int nq, int nkv,
                        int hd, bool with_delta) {
  const int64_t n_qt = (n_t + BQ - 1) / BQ, n_kt = (n_s + BK - 1) / BK;
  BwdWork w;
  w.delta = 0;
  w.ds = with_delta ? ((int64_t)batch * nq * n_t + 3) / 4 * 4 : 0;
  w.dkv = w.ds + (int64_t)batch * nq * n_qt * n_kt * BK * BQ;
  w.total = w.dkv + (nq > nkv ? 2 * (int64_t)batch * n_s * nq * hd : 0);
  return w;
}

// delta[b, hq, t] = sum_d dO[b, t, hq, d] * O[b, t, hq, d]; one warp a row.
// Where m is given (a K4 chain's first call), also lse = m + log l, the
// chain's log-sum-exp (kNegInf where l is 0: a row that saw no key).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       int64_t do_sb, int64_t do_st, int64_t do_sh,
                       float* __restrict__ delta,
                       const float* __restrict__ m,
                       const float* __restrict__ l, float* __restrict__ lse,
                       int batch, int n_t, int nq) {
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
  if (lane == 0) {
    const int64_t r = ((int64_t)b * nq + hq) * n_t + t;
    delta[r] = s;
    if (m != nullptr) lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegInf;
  }
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
// first). It walks the query tiles whose key_tiles hold its tile: loads
// the Q and dO tiles (swizzled), computes S^T = K Q^T and dP^T = V dO^T
// (thread (ty, tx): keys ty + 8 i, queries tx + 16 j), P = exp(S scale -
// lse) and dS = P (dP - delta), zero where masked (so a row whose lse is
// NEG_INF, one that sees no key, gives 0, not NaN), then dV += P^T dO and
// dK += dS^T Q (keys ty + 8 i, columns 4 (tx + 16 c) .. + 3), and writes
// the dS^T tile to the workspace for the dQ pass. With g == 1 it writes dK
// and dV (TO, batch stride o_sb); with GQA its query head's share goes to
// the workspace.
template <typename T, typename TO, int HD, typename Mask, int DV = HD>
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
                      float* __restrict__ dvw, TO* __restrict__ dk,
                      TO* __restrict__ dv, int64_t o_sb, int n_t, int n_s,
                      int nq, int nkv, Mask P, float scale, int vec) {
  constexpr int D4 = HD / 4, D4V = DV / 4;
  constexpr int NC = HD / 64, NCV = DV / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [BK][HD]
  float* Vs = Ks + BK * HD;      // [BK][DV]
  float* Qs = Vs + BK * DV;      // [BQ][HD], chunks swizzled
  float* dOs = Qs + BQ * HD;     // [BQ][DV], chunks swizzled
  float* Ts = dOs + BQ * DV;     // [BK][TLD]: P^T, then dS^T
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
  uint4 reg[Tile<T, (HD > DV ? HD : DV), BQ>::REGS];

  tile_issue<T, HD, BK, false>(Ks, k + b * k_sb + hk * k_sh, k_st, j0, n_s,
                               vec, reg);
  tile_commit<T, HD, BK, false>(Ks, k + b * k_sb + hk * k_sh, k_st, j0, n_s,
                                vec, reg);
  tile_issue<T, DV, BK, false>(Vs, v + b * v_sb + hk * v_sh, v_st, j0, n_s,
                               vec, reg);
  tile_commit<T, DV, BK, false>(Vs, v + b * v_sb + hk * v_sh, v_st, j0, n_s,
                                vec, reg);

  float4 dka[BI][NC], dva[BI][NCV];
#pragma unroll
  for (int i = 0; i < BI; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < NCV; ++c) dva[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    int lo, hi;
    P.template key_tiles<BQ, BK>(q0, &lo, &hi);
    if (kt < lo || kt >= hi) continue;  // block-uniform
    __syncthreads();  // the last tile's readers of Qs, dOs and Ts are done
    tile_issue<T, HD, BQ, true>(Qs, qb, q_st, q0, n_t, vec, reg);
    tile_commit<T, HD, BQ, true>(Qs, qb, q_st, q0, n_t, vec, reg);
    tile_issue<T, DV, BQ, true>(dOs, ob, do_st, q0, n_t, vec, reg);
    tile_commit<T, DV, BQ, true>(dOs, ob, do_st, q0, n_t, vec, reg);
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
    // S^T = K Q^T over HD and dP^T = V dO^T over DV, one loop while the
    // widths agree (the loads of a chunk of both products interleaved)
#pragma unroll 2
    for (int d4 = 0; d4 < (D4 > D4V ? D4 : D4V); ++d4) {
      float4 kv[BI], vv[BI];
#pragma unroll
      for (int i = 0; i < BI; ++i) {
        if (d4 < D4)
          kv[i] = *reinterpret_cast<const float4*>(Ks + (ty + 8 * i) * HD +
                                                   d4 * 4);
        if (d4 < D4V)
          vv[i] = *reinterpret_cast<const float4*>(Vs + (ty + 8 * i) * DV +
                                                   d4 * 4);
      }
#pragma unroll
      for (int j = 0; j < BJ; ++j) {
        const int r = tx + 16 * j;
        float4 qv, ov;
        if (d4 < D4)
          qv = *reinterpret_cast<const float4*>(
              Qs + r * HD + chunk_at<true>(r, d4) * 4);
        if (d4 < D4V)
          ov = *reinterpret_cast<const float4*>(
              dOs + r * DV + chunk_at<true>(r, d4) * 4);
#pragma unroll
        for (int i = 0; i < BI; ++i) {
          if (d4 < D4) {
            s[i][j] = fmaf(kv[i].x, qv.x, s[i][j]);
            s[i][j] = fmaf(kv[i].y, qv.y, s[i][j]);
            s[i][j] = fmaf(kv[i].z, qv.z, s[i][j]);
            s[i][j] = fmaf(kv[i].w, qv.w, s[i][j]);
          }
          if (d4 < D4V) {
            dp[i][j] = fmaf(vv[i].x, ov.x, dp[i][j]);
            dp[i][j] = fmaf(vv[i].y, ov.y, dp[i][j]);
            dp[i][j] = fmaf(vv[i].z, ov.z, dp[i][j]);
            dp[i][j] = fmaf(vv[i].w, ov.w, dp[i][j]);
          }
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
        const bool ok = P.visible(q0 + c, j0 + ty + 8 * i);
        const float p = ok ? expf(s[i][j] * scale - ls) : 0.f;
        Ts[(ty + 8 * i) * TLD + c] = p;
        dp[i][j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    accumulate_tile<DV>(dva, Ts, dOs, ty, tx);  // dV += P^T dO
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
        store4(dk + b * o_sb + ((int64_t)j * nkv + hk) * HD + d, kk);
      } else {
        *reinterpret_cast<float4*>(
            dkw + (((int64_t)b * n_s + j) * nq + hq) * HD + d) = kk;
      }
    }
    // dv's batch stride: o_sb (dk's) scaled from HD to DV wide rows
    const int64_t ov_sb = DV == HD ? o_sb : o_sb / HD * DV;
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
      const int d = (tx + 16 * c) * 4;
      if (g == 1) {
        store4(dv + b * ov_sb + ((int64_t)j * nkv + hk) * DV + d, dva[i][c]);
      } else {
        *reinterpret_cast<float4*>(
            dvw + (((int64_t)b * n_s + j) * nq + hq) * DV + d) = dva[i][c];
      }
    }
  }
}

// dK and dV under GQA: each (batch, key, KV head) row sums its g query
// heads' shares in head order; n4 chunks of 4 in all, per_b of them a
// batch row, written at batch stride o_sb
template <typename TO, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_sum_kernel(const float* __restrict__ dkw,
                     const float* __restrict__ dvw, TO* __restrict__ dk,
                     TO* __restrict__ dv, int64_t n4, int64_t per_b,
                     int64_t o_sb, int g) {
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
  const int64_t dst = (e / per_b) * o_sb + (e % per_b) * 4;
  store4(dk + dst, sk);
  store4(dv + dst, sv);
}

// dQ = scale * dS K, from the dS^T tiles the dK/dV pass wrote: one block of
// 128 threads per (query head, batch, query tile), the query tiles last to
// first (heaviest first under a causal mask), walking its key_tiles in
// order, so each row's sum runs in one fixed order. K and dS^T tiles are
// double-staged (cp.async; bf16 K through registers). Thread (ty, tx) owns
// rows 4 ty + r and 32 + 4 ty + r (r < 4), read from dS^T as two float4 a
// key, and columns 4 (tx + 16 c) .. + 3. ADD (K4): dq is a chain's fp32
// sum, and the block adds its rows' share; else (K2) it stores dQ in TO.
template <typename T, typename TO, int HD, bool ADD, typename Mask>
__global__ void __launch_bounds__(kTileThreads)
flash_bwd_dq_kernel(const T* __restrict__ k, int64_t k_sb, int64_t k_st,
                    int64_t k_sh, const float* __restrict__ ds,
                    TO* __restrict__ dq, int n_t, int n_s, int nq, int nkv,
                    Mask P, float scale, int vec) {
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
  P.template key_tiles<BQ, BK>(q0, &lo, &hi);
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
      TO* row = dq + (((int64_t)b * n_t + t) * nq + hq) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 a =
            make_float4(acc[h][r][c].x * scale, acc[h][r][c].y * scale,
                        acc[h][r][c].z * scale, acc[h][r][c].w * scale);
        TO* p = row + (tx + 16 * c) * 4;
        if constexpr (ADD) {
          static_assert(sizeof(TO) == 4, "dQ sums in fp32");
          const float4 was = *reinterpret_cast<const float4*>(p);
          *reinterpret_cast<float4*>(p) = make_float4(
              was.x + a.x, was.y + a.y, was.z + a.z, was.w + a.w);
        } else {
          store4(p, a);
        }
      }
    }
}

// The backward's kernels on one stream, in order: delta (where o is given;
// else the caller's delta is read; with m and l also lse), dK/dV, the GQA
// sum (g > 1), dQ. work is bwd_work's workspace (16-byte aligned); lse and
// delta (batch, nq, n_t) fp32, delta in the workspace where it is null
// (K2's);
// dq (batch, n_t, nq, HD) contiguous; dk (batch, n_s, nkv, HD) at batch
// stride dkv_sb and dv (batch, n_s, nkv, DV) at dkv_sb / HD * DV,
// contiguous within a batch row; o and dout DV wide. DV != HD takes g ==
// 1 only. Returns the first launch error.
template <typename T, typename TO, int HD, bool ADD_DQ, typename Mask,
          int DV = HD>
int launch_bwd(const Args<Mask>& a, const void* o, const float* m,
               const float* l, const void* dout, long long do_sb,
               long long do_st, long long do_sh, float* lse, float* delta,
               float* work, void* dq, void* dk, void* dv, long long dkv_sb,
               cudaStream_t s) {
  const BwdWork w = bwd_work(a.batch, a.n_t, a.n_s, a.nq, a.nkv, HD,
                             delta == nullptr);
  if (delta == nullptr) delta = work + w.delta;
  const int g = a.nq / a.nkv;
  float* dkw = g > 1 ? work + w.dkv : nullptr;
  float* dvw = g > 1 ? dkw + (int64_t)a.batch * a.n_s * a.nq * HD : nullptr;
  cudaError_t err;
  if (o != nullptr) {
    const int64_t rows = (int64_t)a.batch * a.n_t * a.nq;
    flash_bwd_delta_kernel<T, DV><<<(unsigned)((rows + 7) / 8), kThreads, 0,
                                    s>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), do_sb, do_st,
        do_sh, delta, m, l, lse, a.batch, a.n_t, a.nq);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const bool vec = rows_aligned<T>(a.q, a.q_sb, a.q_st, a.q_sh) &&
                   rows_aligned<T>(a.k, a.k_sb, a.k_st, a.k_sh) &&
                   rows_aligned<T>(a.v, a.v_sb, a.v_st, a.v_sh) &&
                   rows_aligned<T>(dout, do_sb, do_st, do_sh);
  const int n_qt = (a.n_t + BQ - 1) / BQ, n_kt = (a.n_s + BK - 1) / BK;
  auto kdkdv = flash_bwd_dkdv_kernel<T, TO, HD, Mask, DV>;
  static const cudaError_t attr_kv =
      allow_smem(kdkdv, dkdv_tile_smem<HD, DV>());
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  kdkdv<<<dim3(a.nq, a.batch, n_kt), kTileThreads, dkdv_tile_smem<HD, DV>(),
          s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      lse, delta, work + w.ds, dkw, dvw,
      static_cast<TO*>(dk), static_cast<TO*>(dv), dkv_sb, a.n_t, a.n_s, a.nq,
      a.nkv, a.pos, a.scale, (int)vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if constexpr (DV != HD) {
    if (g > 1) return (int)cudaErrorInvalidValue;  // no GQA sum of two widths
  } else if (g > 1) {
    const int64_t per_b = (int64_t)a.n_s * a.nkv * HD / 4;
    const int64_t n4 = a.batch * per_b;
    flash_bwd_sum_kernel<TO, HD><<<(unsigned)((n4 + kThreads - 1) / kThreads),
                                   kThreads, 0, s>>>(
        dkw, dvw, static_cast<TO*>(dk), static_cast<TO*>(dv), n4, per_b,
        dkv_sb, g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  auto kdq = flash_bwd_dq_kernel<T, TO, HD, ADD_DQ, Mask>;
  static const cudaError_t attr_q = allow_smem(kdq, dq_tile_smem<HD>());
  if (attr_q != cudaSuccess) return (int)attr_q;
  kdq<<<dim3(a.nq, a.batch, n_qt), kTileThreads, dq_tile_smem<HD>(), s>>>(
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh, work + w.ds,
      static_cast<TO*>(dq), a.n_t, a.n_s, a.nq, a.nkv, a.pos, a.scale,
      (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace
