// K4, partial flash attention over one KV block, forward and backward, for
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_partial
// (Pallas body `_partial_kernel`), whose jnp oracle is
// repro.layers.attention.attn_core_partial. One KV block of an online
// softmax: the fp32 carry (m, l, acc) of each query row comes in and goes
// out unnormalised, so the blocks of a context-parallel all-gather chain
// through it. Positions are affine in the local index, query row i at
// q_pos0 + i * q_stride and key j at k_pos0 + j * k_stride (the striped
// layout of a seq axis of size p: stride p), and the causal and window
// masks run on them. Rows at or past q_len and keys at or past kv_len are
// masked. Under the mask p is zeroed, so a row that sees no key of the
// block keeps its carry bit for bit (alpha = exp(0) = 1, p = 0).
// The JAX package has no backward kernel: it differentiates the jnp
// oracle. The backward here is FlashAttention-2's for one block of a
// chain, given the chain's final lse = m + log l and delta = rowsum(dO * O):
//     P = exp(S - lse), dV = P^T dO, dS = P (dO V^T - delta),
//     dQ += dS K * scale, dK = dS^T Q * scale.
//
// What bounds it: at the seq-parallel training shape (per rank, B 2, T 256
// queries, one block of 256 keys, 16/8 heads, head_dim 128, causal under
// stride 2) operations: 4 * head_dim per visible (query, key) pair forward
// and 10 * head_dim backward, against (T + 2 S) head_dim elements and the
// fp32 carry moved, tens of operations per byte. In float32 the bound is
// the CUDA cores' 67 TFLOP/s.
//
// Design:
//  * forward: K2's register-tiled walk (`attend` in attention_tiles.cuh:
//    128 threads, float4 reads, K swizzled, K and V double-staged) on
//    query tiles of 32 rows, one block per (query head, batch, query
//    tile), the last tiles first. At the seq path's shape 64-row tiles
//    would give 128 blocks a launch for the 264 slots of 132 SMs at two
//    blocks each (88 KB of shared memory a block); 32-row tiles give 256,
//    each thread 4 rows x 4 keys. A block walks the key tiles from the
//    first to the last that tile_live finds, decided from the tiles'
//    corner positions (strides are at least 1, so positions grow with
//    the index); a masked tile leaves each row's carry bitwise unchanged;
//  * backward, still the first port's 256-thread tiles, two kernels (delta
//    comes from the caller): dK and dV, one block per (key tile, KV head,
//    batch) that loops over the g query heads of its group and the query
//    tiles, so the GQA sum stays in the block; dQ, one block per (query
//    tile, query head, batch) that loops over the key tiles and adds its
//    sum into the fp32 dQ of the chain. No atomics: two runs on the same
//    inputs give the same bits, as remat needs.
// All of q, k, v and dO are read in the model's (batch, time, head,
// head_dim) layout through strides, with unit stride in head_dim, so a KV
// block is a slice of the gathered keys with no copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

// the affine positions and the masks of one call
struct Pos {
  int q0, qs, k0, ks;   // query i at q0 + i * qs, key j at k0 + j * ks
  int q_hi, kv_hi;      // rows < q_hi and keys < kv_hi take part
  int causal, window;
};

__device__ __forceinline__ bool visible(const Pos& P, int i, int j) {
  if (i >= P.q_hi || j >= P.kv_hi) return false;
  const int iq = P.q0 + i * P.qs, jk = P.k0 + j * P.ks;
  return (!P.causal || iq >= jk) && (P.window <= 0 || iq - jk < P.window);
}

// false only if every pair of query rows [a, a + ROWS) and keys [c, c +
// BKV) is masked; block-uniform, so a loop may skip on it between barriers
template <int ROWS = BQ>
__device__ __forceinline__ bool tile_live(const Pos& P, int a, int c) {
  const int b = min(a + ROWS, P.q_hi), d = min(c + BKV, P.kv_hi);
  if (a >= b || c >= d) return false;
  const int q_min = P.q0 + a * P.qs, q_max = P.q0 + (b - 1) * P.qs;
  const int k_min = P.k0 + c * P.ks, k_max = P.k0 + (d - 1) * P.ks;
  if (P.causal && q_max < k_min) return false;
  if (P.window > 0 && q_min - k_max >= P.window) return false;
  return true;
}

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

constexpr int KQ = 32;       // query rows of a forward block
constexpr int KR = KQ / 8;   // query rows of a thread: ty + 8 i

// One block of 128 threads per (query head, batch, 32-row query tile), the
// query tiles last to first (positions grow with the index, so under a
// causal mask the last tiles see the most keys and start first). The block
// loads its rows' carry, walks the key tiles from the first live one to the
// last (attend in attention_tiles.cuh; a masked tile between them leaves
// the carry bitwise as it is) and stores the new carry, unnormalised.
template <typename T, int HD>
__global__ void __launch_bounds__(kTileThreads, 2)
partial_fwd_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                   int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                   int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                   int64_t v_sb, int64_t v_st, int64_t v_sh,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   const float* __restrict__ acc_in,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out, int n_t, int n_s, int nq,
                   int nkv, Pos P, float scale, int vec) {
  constexpr int NC = HD / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [KQ][HD]
  float* Ks = Qs + KQ * HD;     // [BKV][HD], chunks swizzled
  float* Vs = Ks + BKV * HD;    // [BKV][HD]
  float* Ps = Vs + BKV * HD;    // [KQ][BKV]
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * KQ;
  const int hk = hq / (nq / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t row0 = ((int64_t)b * nq + hq) * n_t;   // carry row of t = 0
  const T* qb = q + b * q_sb + hq * q_sh;
  uint4 reg[Tile<T, HD, BKV>::REGS];

  float m[KR], l[KR];
  float4 acc[KR][NC];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int t = q0 + ty + 8 * i;
    const bool in = t < n_t;
    m[i] = in ? m_in[row0 + t] : kNegInf;
    l[i] = in ? l_in[row0 + t] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c] = in ? *reinterpret_cast<const float4*>(
                           acc_in + (row0 + t) * HD + (tx + 16 * c) * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_tiles = (n_s + BKV - 1) / BKV;
  int lo = 0, hi = n_tiles;
  while (lo < hi && !tile_live<KQ>(P, q0, lo * BKV)) ++lo;
  while (hi > lo && !tile_live<KQ>(P, q0, (hi - 1) * BKV)) --hi;
  tile_issue<T, HD, KQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  tile_commit<T, HD, KQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  attend<T, HD, KR>(Qs, Ks, Vs, Ps, k + b * k_sb + hk * k_sh, k_st,
                    v + b * v_sb + hk * v_sh, v_st, n_s, lo, hi, vec, reg,
                    scale, [&](int r, int j) { return visible(P, q0 + r, j); },
                    m, l, acc);

#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int t = q0 + ty + 8 * i;
    if (t >= n_t) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(acc_out + (row0 + t) * HD +
                                 (tx + 16 * c) * 4) = acc[i][c];
    if (tx == 0) {
      m_out[row0 + t] = m[i];
      l_out[row0 + t] = l[i];
    }
  }
}

// ---------------------------------------------------------------------- //
// backward
// ---------------------------------------------------------------------- //

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
partial_bwd_dkdv_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                        int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                        int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                        int64_t v_sb, int64_t v_st, int64_t v_sh,
                        const T* __restrict__ dout, int64_t do_sb,
                        int64_t do_st, int64_t do_sh,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int n_t, int n_s, int nq, int nkv, Pos P,
                        float scale) {
  constexpr int HC = HD / 16;
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                // [BKV][LD]
  float* Vs = Ks + BKV * LD;       // [BKV][LD]
  float* Qs = Vs + BKV * LD;       // [BQ][LD]
  float* dOs = Qs + BQ * LD;       // [BQ][LD]
  float* Pt = dOs + BQ * LD;       // [BKV][PLD]: P transposed
  float* dSt = Pt + BKV * PLD;     // [BKV][PLD]: dS transposed
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

  const int n_qt = (n_t + BQ - 1) / BQ;
  for (int gi = 0; gi < g; ++gi) {
    const int hq = hk * g + gi;
    const float* lse_h = lse + ((int64_t)b * nq + hq) * n_t;
    const float* del_h = delta + ((int64_t)b * nq + hq) * n_t;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_live(P, q0, j0)) continue;
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
          const bool ok = visible(P, q0 + c, jk);
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
      dk[off + tx + 16 * c] = dka[i][c] * scale;
      dv[off + tx + 16 * c] = dva[i][c];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
partial_bwd_dq_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                      int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                      int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                      int64_t v_sb, int64_t v_st, int64_t v_sh,
                      const T* __restrict__ dout, int64_t do_sb,
                      int64_t do_st, int64_t do_sh,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq, int n_t, int n_s, int nq,
                      int nkv, Pos P, float scale) {
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

  const int n_tiles = (n_s + BKV - 1) / BKV;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * BKV;
    if (!tile_live(P, q0, j0)) continue;
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
      const int li = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const bool ok = visible(P, li, j0 + tx + 16 * j);
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

  // dq += this block's share; one block owns each row, so no atomics
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= n_t) continue;
    float* row = dq + (((int64_t)b * n_t + t) * nq + hq) * HD;
#pragma unroll
    for (int c = 0; c < HC; ++c) row[tx + 16 * c] += dqa[i][c] * scale;
  }
}

struct Args {
  const void *q, *k, *v;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int batch, n_t, n_s, nq, nkv;
  Pos pos;
  float scale;
};

template <typename T, int HD>
int fwd(const Args& a, const void* m_in, const void* l_in,
        const void* acc_in, void* m_out, void* l_out, void* acc_out,
        cudaStream_t s) {
  auto kern = partial_fwd_kernel<T, HD>;
  static const cudaError_t attr = allow_smem(kern, attend_smem<HD, KQ>());
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = rows_aligned<T>(a.q, a.q_sb, a.q_st, a.q_sh) &&
                   rows_aligned<T>(a.k, a.k_sb, a.k_st, a.k_sh) &&
                   rows_aligned<T>(a.v, a.v_sb, a.v_st, a.v_sh);
  const dim3 grid(a.nq, a.batch, (a.n_t + KQ - 1) / KQ);
  kern<<<grid, kTileThreads, attend_smem<HD, KQ>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const float*>(m_in), static_cast<const float*>(l_in),
      static_cast<const float*>(acc_in), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), a.n_t,
      a.n_s, a.nq, a.nkv, a.pos, a.scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd(const Args& a, const void* dout, long long do_sb, long long do_st,
        long long do_sh, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, cudaStream_t s) {
  auto kdkdv = partial_bwd_dkdv_kernel<T, HD>;
  static const cudaError_t attr_kv = allow_smem(kdkdv, dkdv_smem<HD>());
  if (attr_kv != cudaSuccess) return (int)attr_kv;
  const dim3 gkv((a.n_s + BKV - 1) / BKV, a.nkv, a.batch);
  kdkdv<<<gkv, kThreads, dkdv_smem<HD>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.n_t, a.n_s, a.nq,
      a.nkv, a.pos, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kdq = partial_bwd_dq_kernel<T, HD>;
  static const cudaError_t attr_q = allow_smem(kdq, dq_smem<HD>());
  if (attr_q != cudaSuccess) return (int)attr_q;
  const dim3 gq((a.n_t + BQ - 1) / BQ, a.nq, a.batch);
  kdq<<<gq, kThreads, dq_smem<HD>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<const T*>(dout), do_sb, do_st, do_sh,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), a.n_t, a.n_s, a.nq, a.nkv, a.pos, a.scale);
  return (int)cudaGetLastError();
}

int check(const Args& a, int head_dim, int dtype) {
  if (a.nkv <= 0 || a.nq % a.nkv || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1) || a.pos.qs < 1 || a.pos.ks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

Args make_args(const void* q, long long q_sb, long long q_st, long long q_sh,
               const void* k, long long k_sb, long long k_st, long long k_sh,
               const void* v, long long v_sb, long long v_st, long long v_sh,
               int batch, int n_t, int n_s, int nq, int nkv, int q_pos0,
               int q_stride, int k_pos0, int k_stride, int q_len, int kv_len,
               int causal, int window, float scale) {
  const int q_hi = q_len > 0 && q_len < n_t ? q_len : n_t;
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  const Pos pos{q_pos0, q_stride, k_pos0, k_stride, q_hi, kv_hi, causal,
                window};
  return Args{q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
              v_sh, batch, n_t, n_s, nq, nkv, pos, scale};
}

}  // namespace

#define K4_DISPATCH(FN, ...)                                              \
  (dtype == 0 ? (head_dim == 128 ? FN<float, 128>(__VA_ARGS__)            \
                                 : FN<float, 64>(__VA_ARGS__))            \
              : (head_dim == 128 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)    \
                                 : FN<__nv_bfloat16, 64>(__VA_ARGS__)))

// q (batch, n_t, nq, head_dim) and k, v (batch, n_s, nkv, head_dim) through
// their (batch, time, head) strides, unit stride in head_dim. The carry in
// and out: m, l (batch, nq, n_t) and acc (batch, nq, n_t, head_dim), fp32
// contiguous, acc 16-byte aligned (out may alias in). Query row i sits at
// q_pos0 + i * q_stride, key j at k_pos0 + j * k_stride (strides >= 1);
// rows at or past q_len and keys at or past kv_len are masked (<= 0:
// none). dtype 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns
// cudaGetLastError().
extern "C" int partial_attention_fwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* m_in, const void* l_in, const void* acc_in, void* m_out,
    void* l_out, void* acc_out, int batch, int n_t, int n_s, int nq,
    int nkv, int head_dim, int q_pos0, int q_stride, int k_pos0,
    int k_stride, int q_len, int kv_len, int causal, int window, float scale,
    int dtype, void* stream) {
  const Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb,
                           v_st, v_sh, batch, n_t, n_s, nq, nkv, q_pos0,
                           q_stride, k_pos0, k_stride, q_len, kv_len, causal,
                           window, scale);
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K4_DISPATCH(fwd, a, m_in, l_in, acc_in, m_out, l_out, acc_out, s);
}

// The forward's q, k, v and positions, dout (the gradient of the chain's
// output, through strides, shaped like q), and the chain's lse and delta
// (batch, nq, n_t) fp32. Adds the block's share into dq (batch, n_t, nq,
// head_dim) fp32 and writes dk, dv (batch, n_s, nkv, head_dim) fp32, all
// contiguous. Returns cudaGetLastError().
extern "C" int partial_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* dout, long long do_sb, long long do_st, long long do_sh,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int n_t, int n_s, int nq, int nkv, int head_dim, int q_pos0,
    int q_stride, int k_pos0, int k_stride, int q_len, int kv_len,
    int causal, int window, float scale, int dtype, void* stream) {
  const Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb,
                           v_st, v_sh, batch, n_t, n_s, nq, nkv, q_pos0,
                           q_stride, k_pos0, k_stride, q_len, kv_len, causal,
                           window, scale);
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K4_DISPATCH(bwd, a, dout, do_sb, do_st, do_sh, lse, delta, dq, dk,
                     dv, s);
}
