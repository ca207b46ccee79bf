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
//    dS = P (dO V^T - delta), dQ = dS K scale, dK = dS^T Q scale): the four
//    kernels of attention_tiles.cuh (`launch_bwd`, shared with K4's
//    backward), no atomics, every sum in a fixed order, so that two calls
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
//    Here they store dQ, dK and dV in the inputs' dtype.
// All inputs are read in the model's (batch, time, head, head_dim) layout
// through strides, with unit stride in head_dim: no transposes.
//
// Head dims: 64 and 128, and MLA's (q/k 192, v 128), DeepSeek-V2's
// qk_nope 128 + qk_rope 64 beside its v 128. The tiles take the two
// widths apart (attention_tiles.cuh's HD for q and k, DV for v, the
// output and dO): the scores and dP^T loop over their own widths, dK and
// dQ are 192 wide and dV 128. At (192, 128) the forward's shared memory
// is Q and K 64 x 192 and V 64 x 128 and P 64 x 64 floats, 144 KB, and
// the dK/dV pass's 130.5 KB: one block an SM, not two, of the H100's 228
// KB. Keeping two would take 32-row query tiles, which load every K and V
// tile twice as often per query row; this first port keeps the 64-row
// tiles, and PERF.md times it against SDPA. MLA has as many KV heads as
// query heads, so a
// width pair other than (64, 64) or (128, 128) takes g == 1 only (no GQA
// sum of two widths).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using K2Args = Args<IndexMask>;

// ---------------------------------------------------------------------- //
// forward
// ---------------------------------------------------------------------- //

constexpr int FR = BQ / 8;  // query rows of a thread: ty + 8 i

// One block of 128 threads per (query head, batch, 64-row query tile); the
// query tiles run last to first, so that under a causal mask the blocks
// with the most key tiles start first. The block walks the key tiles that
// hold a visible key (attend in attention_tiles.cuh) from an empty carry
// and writes the normalised output and each row's log-sum-exp.
template <typename T, int HD, int DV>
__global__ void __launch_bounds__(kTileThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st,
                 int64_t q_sh, const T* __restrict__ k, int64_t k_sb,
                 int64_t k_st, int64_t k_sh, const T* __restrict__ v,
                 int64_t v_sb, int64_t v_st, int64_t v_sh,
                 T* __restrict__ o, float* __restrict__ lse, int n_t,
                 int n_s, int nq, int nkv, IndexMask P, float scale,
                 int vec) {
  constexpr int NC = DV / 64;  // output chunks of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BQ][HD]
  float* Ks = Qs + BQ * HD;     // [BKV][HD], chunks swizzled
  float* Vs = Ks + BKV * HD;    // [BKV][DV]
  float* Ps = Vs + BKV * DV;    // [BQ][BKV]
  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = hq / (nq / nkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * q_sb + hq * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  uint4 reg[Tile<T, (HD > DV ? HD : DV), BQ>::REGS];

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
  P.key_tiles<BQ, BKV>(q0, &lo, &hi);
  tile_issue<T, HD, BQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  tile_commit<T, HD, BQ, false>(Qs, qb, q_st, q0, n_t, vec, reg);
  attend<T, HD, FR, IndexMask, DV>(Qs, Ks, Vs, Ps, kb, k_st, vb, v_st, n_s,
                                   lo, hi, vec, reg, scale, P, q0, m, l,
                                   acc);

#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int t = q0 + ty + 8 * i;
    if (t >= n_t) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * n_t + t) * nq + hq) * DV;
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

template <typename T, int HD, int DV>
int fwd(const K2Args& a, void* o, void* lse, cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, HD, DV>;
  static const cudaError_t attr =
      allow_smem(kern, attend_smem<HD, BQ, DV>());
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = rows_aligned<T>(a.q, a.q_sb, a.q_st, a.q_sh) &&
                   rows_aligned<T>(a.k, a.k_sb, a.k_st, a.k_sh) &&
                   rows_aligned<T>(a.v, a.v_sb, a.v_st, a.v_sh);
  const dim3 grid(a.nq, a.batch, (a.n_t + BQ - 1) / BQ);
  kern<<<grid, kTileThreads, attend_smem<HD, BQ, DV>(), s>>>(
      static_cast<const T*>(a.q), a.q_sb, a.q_st, a.q_sh,
      static_cast<const T*>(a.k), a.k_sb, a.k_st, a.k_sh,
      static_cast<const T*>(a.v), a.v_sb, a.v_st, a.v_sh,
      static_cast<T*>(o), static_cast<float*>(lse), a.n_t, a.n_s, a.nq,
      a.nkv, a.pos, a.scale, (int)vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int DV>
int bwd(const K2Args& a, const void* o, const void* dout, long long do_sb,
        long long do_st, long long do_sh, const void* lse, void* work,
        void* dq, void* dk, void* dv, cudaStream_t s) {
  return launch_bwd<T, T, HD, false, IndexMask, DV>(
      a, o, nullptr, nullptr, dout, do_sb, do_st, do_sh,
      static_cast<float*>(const_cast<void*>(lse)), nullptr,
      static_cast<float*>(work), dq, dk, dv, (long long)a.n_s * a.nkv * HD,
      s);  // dv's batch stride n_s nkv DV follows from dk's
}

// the call's Args: keys at or past kv_len (> 0) are masked
K2Args make_args(const void* q, long long q_sb, long long q_st,
                 long long q_sh, const void* k, long long k_sb,
                 long long k_st, long long k_sh, const void* v,
                 long long v_sb, long long v_st, long long v_sh, int batch,
                 int n_t, int n_s, int nq, int nkv, int causal, int window,
                 int kv_len, float scale) {
  const int kv_hi = kv_len > 0 && kv_len < n_s ? kv_len : n_s;
  return K2Args{q,     k,    v,    q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                v_sb,  v_st, v_sh, batch, n_t, n_s, nq,   nkv,
                IndexMask{n_t, kv_hi, causal, window}, scale};
}

// the (q/k, v) widths built: 64 and 128, and MLA's (192, 128)
bool dims_ok(int head_dim, int v_dim) {
  return (head_dim == v_dim && (head_dim == 64 || head_dim == 128)) ||
         (head_dim == 192 && v_dim == 128);
}

int check(const K2Args& a, int head_dim, int v_dim, int dtype) {
  if (a.nkv <= 0 || a.nq % a.nkv || !dims_ok(head_dim, v_dim) ||
      (head_dim != v_dim && a.nq != a.nkv) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

#define K2_DIMS(FN, T, ...)                                               \
  (head_dim == 192 ? FN<T, 192, 128>(__VA_ARGS__)                         \
   : head_dim == 128 ? FN<T, 128, 128>(__VA_ARGS__)                       \
                     : FN<T, 64, 64>(__VA_ARGS__))
#define K2_DISPATCH(FN, ...)                                              \
  (dtype == 0 ? K2_DIMS(FN, float, __VA_ARGS__)                           \
              : K2_DIMS(FN, __nv_bfloat16, __VA_ARGS__))

// q (batch, n_t, nq, head_dim), k (batch, n_s, nkv, head_dim) and v
// (batch, n_s, nkv, v_dim) through their (batch, time, head) strides, unit
// stride in the last dim. o (batch, n_t, nq, v_dim) contiguous; lse
// (batch, nq, n_t) fp32. Keys at or past kv_len are masked (kv_len <= 0:
// none). dtype 0 = float32, 1 = bfloat16; (head_dim, v_dim) (64, 64),
// (128, 128) or, with nq == nkv, (192, 128). Returns cudaGetLastError().
extern "C" int flash_attention_fwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh, void* o,
    void* lse, int batch, int n_t, int n_s, int nq, int nkv, int head_dim,
    int v_dim, int causal, int window, int kv_len, float scale, int dtype,
    void* stream) {
  const K2Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v,
                             v_sb, v_st, v_sh, batch, n_t, n_s, nq, nkv,
                             causal, window, kv_len, scale);
  if (int bad = check(a, head_dim, v_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K2_DISPATCH(fwd, a, o, lse, s);
}

// Floats of the backward's fp32 workspace (bwd_work), for the caller to
// allocate; -1 on a shape the backward refuses.
extern "C" long long flash_attention_bwd_workspace(int batch, int n_t,
                                                   int n_s, int nq, int nkv,
                                                   int head_dim, int v_dim) {
  if (nkv <= 0 || nq % nkv || !dims_ok(head_dim, v_dim) ||
      (head_dim != v_dim && nq != nkv)) {
    return -1;
  }
  return bwd_work(batch, n_t, n_s, nq, nkv, head_dim, true).total;
}

// The forward's inputs, its output o and lse, and dout (the gradient of
// o, through strides). work is the fp32 workspace of
// flash_attention_bwd_workspace floats, 16-byte aligned; dq, dk, dv are
// contiguous in the layouts of q, k, v (dv and o v_dim wide). Returns
// cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    const void* o, const void* dout, long long do_sb, long long do_st,
    long long do_sh, const void* lse, void* work, void* dq, void* dk,
    void* dv, int batch, int n_t, int n_s, int nq, int nkv, int head_dim,
    int v_dim, int causal, int window, int kv_len, float scale, int dtype,
    void* stream) {
  const K2Args a = make_args(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v,
                             v_sb, v_st, v_sh, batch, n_t, n_s, nq, nkv,
                             causal, window, kv_len, scale);
  if (int bad = check(a, head_dim, v_dim, dtype)) return bad;
  if (batch <= 0 || n_t <= 0 || n_s <= 0 || nq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K2_DISPATCH(bwd, a, o, dout, do_sb, do_st, do_sh, lse, work, dq,
                     dk, dv, s);
}
