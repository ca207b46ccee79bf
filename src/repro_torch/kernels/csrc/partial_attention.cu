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
//    each thread 4 rows x 4 keys. A block walks the key tiles that
//    Pos::key_tiles finds from the tiles' corner positions (strides are at
//    least 1, so positions grow with the index); a masked tile leaves each
//    row's carry bitwise unchanged;
//  * backward: K2's backward kernels (`launch_bwd` in attention_tiles.cuh:
//    a dK/dV pass of one block of 128 threads per query head, batch and
//    32-key tile, 256 blocks at the seq shape for the 264 two-block slots,
//    writing each live (64-query, 32-key) dS tile to an fp32 workspace; an
//    in-order GQA sum; a dQ pass reading dS back), with this call's
//    positions and masks. The call adds its block's share into the
//    chain's fp32 dQ (one block owns each row, and the chain calls its
//    blocks in order, so each row's sum runs in one order) and writes dK
//    and dV in fp32, at a batch stride, so that each block lands in its
//    slice of the gathered keys' gradient. The chain's first call also
//    closes the chain: delta from the finalised output and lse = m + log
//    l, in the delta kernel. No atomics: two runs on the same inputs give
//    the same bits, as remat needs.
// All of q, k, v and dO are read in the model's (batch, time, head,
// head_dim) layout through strides, with unit stride in head_dim, so a KV
// block is a slice of the gathered keys with no copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using K4Args = Args<Pos>;

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

constexpr int KQ = 32;       // query rows of a forward block
constexpr int KR = KQ / 8;   // query rows of a thread: ty + 8 i

// One block of 128 threads per (query head, batch, 32-row query tile), the
// query tiles last to first (positions grow with the index, so under a
// causal mask the last tiles see the most keys and start first). The block
// loads its rows' carry, walks its key_tiles (attend in
// attention_tiles.cuh; a masked tile among them leaves the carry bitwise as
// it is) and stores the new carry, unnormalised.
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
  int lo, hi;
  P.key_tiles<KQ, BKV>(q0, &lo, &hi);
  tile_issue<T, HD, KQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  tile_commit<T, HD, KQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  attend<T, HD, KR>(Qs, Ks, Vs, Ps, k + b * k_sb + hk * k_sh, k_st,
                    v + b * v_sb + hk * v_sh, v_st, n_s, lo, hi, vec, reg,
                    scale, P, q0, m, l, acc);

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

template <typename T, int HD>
int fwd(const K4Args& a, const void* m_in, const void* l_in,
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
int bwd(const K4Args& a, const void* dout, long long do_sb, long long do_st,
        long long do_sh, const void* o, const void* m, const void* l,
        void* lse, void* delta, void* work, void* dq, void* dk, void* dv,
        long long dkv_sb, cudaStream_t s) {
  return launch_bwd<T, float, HD, true>(
      a, o, static_cast<const float*>(m), static_cast<const float*>(l), dout,
      do_sb, do_st, do_sh, static_cast<float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(work), dq, dk, dv,
      dkv_sb, s);
}

int check(const K4Args& a, int head_dim, int dtype) {
  if (a.nkv <= 0 || a.nq % a.nkv || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1) || a.pos.qs < 1 || a.pos.ks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

K4Args make_args(const void* q, long long q_sb, long long q_st, long long q_sh,
               const void* k, long long k_sb, long long k_st, long long k_sh,
               const void* v, long long v_sb, long long v_st, long long v_sh,
               int batch, int n_t, int n_s, int nq, int nkv, int q_pos0,
               int q_stride, int k_pos0, int k_stride, int q_len, int kv_len,
               int causal, int window, float scale) {
  const int q_hi = q_len > 0 && q_len < n_t ? q_len : n_t;
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  const Pos pos{q_pos0, q_stride, k_pos0, k_stride, q_hi, kv_hi, causal,
                window};
  return K4Args{q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
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
  const K4Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb,
                           v_st, v_sh, batch, n_t, n_s, nq, nkv, q_pos0,
                           q_stride, k_pos0, k_stride, q_len, kv_len, causal,
                           window, scale);
  if (int bad = check(a, head_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K4_DISPATCH(fwd, a, m_in, l_in, acc_in, m_out, l_out, acc_out, s);
}

// Floats of the backward's fp32 workspace (bwd_work without delta, which
// comes from the chain), for the caller to allocate; -1 on a shape the
// backward refuses.
extern "C" long long partial_attention_bwd_workspace(int batch, int n_t,
                                                     int n_s, int nq,
                                                     int nkv, int head_dim) {
  if (nkv <= 0 || nq % nkv || (head_dim != 64 && head_dim != 128)) return -1;
  return bwd_work(batch, n_t, n_s, nq, nkv, head_dim, false).total;
}

// The forward's q, k, v and positions, dout (the gradient of the chain's
// output, through strides, shaped like q), and the chain's lse and delta
// (batch, nq, n_t) fp32. The chain's first call gives o (its finalised
// output, contiguous, shaped like q, in q's dtype) and its final m and l
// (batch, nq, n_t) fp32, and the call writes delta = rowsum(dout * o) and
// lse = m + log l (NEG_INF where l is 0) first; a later call gives null
// for the three and reads them. work is the fp32 workspace of
// partial_attention_bwd_workspace floats, 16-byte aligned. Adds the
// block's share into dq (batch, n_t, nq, head_dim) fp32 contiguous and
// writes dk, dv (batch, n_s, nkv, head_dim) fp32 at batch stride dkv_sb,
// contiguous within a batch row. Returns the first launch error.
extern "C" int partial_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* dout, long long do_sb, long long do_st, long long do_sh,
    const void* o, const void* m, const void* l, void* lse, void* delta,
    void* work, void* dq, void* dk, void* dv, long long dkv_sb, int batch,
    int n_t, int n_s, int nq, int nkv, int head_dim, int q_pos0,
    int q_stride, int k_pos0, int k_stride, int q_len, int kv_len,
    int causal, int window, float scale, int dtype, void* stream) {
  const K4Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb,
                           v_st, v_sh, batch, n_t, n_s, nq, nkv, q_pos0,
                           q_stride, k_pos0, k_stride, q_len, kv_len, causal,
                           window, scale);
  if (int bad = check(a, head_dim, dtype)) return bad;
  if ((o == nullptr) != (m == nullptr) || (m == nullptr) != (l == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K4_DISPATCH(bwd, a, dout, do_sb, do_st, do_sh, o, m, l, lse, delta,
                     work, dq, dk, dv, dkv_sb, s);
}
