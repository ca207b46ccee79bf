// K1, the local GEMM for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/block_matmul.py:block_matmul (Pallas body
// `_kernel`), the local GEMM of paper Algorithm 1 (lines 6/13):
//     out (M, N) = a (M, K) @ b (K, N)
// with fp32 accumulation across K and the output in the inputs' dtype, as
// repro.core.parallel._mm computes it, or in float32 for bf16 inputs (a
// weight gradient, reduce-scattered over z in fp32 before its one rounding,
// as the reference's dW and tied-head dtable are). Each operand comes with its own row
// and column strides, so the layouts of the model run without copies: X.W
// (NN), dY.W^T and h.E^T (NT, b read through a transposed view), X^T.dY
// (TN, a read through a transposed view) and a column slice of a wider
// activation (SN: a's row stride above K).
//
// What bounds it: at the training and prefill shapes (M in the thousands)
// operations: 2MNK of them against (MK + KN + MN) elements moved is
// hundreds of operations per byte. The float32 path stays float32 (no
// TF32), so the bound is the 67 TFLOP/s of the CUDA cores. At decode (M <=
// 16 rows) it is bytes: each weight element is read once for at most 32
// operations, and the card's 3.35 TB/s is the limit.
//
// Design. Three paths; the wrapper (kernels/block_matmul.py) picks one
// from M and the operands' layout, and how many ways K is split.
//  * Tiles (M > 16): a 128 x 128 block tile (64 x 128 for M <= 64), depth
//    16, each warp a 32 x 64 region, each thread 8 x 8 outputs as 2 x 2
//    fragments of 4 x 4, so that one k-step reads two float4 of A and two
//    of B from shared memory for 64 FMAs. Shared memory holds the tiles
//    K-major in fp32 (bf16 widens on the way in), double-buffered: the next
//    tile's global loads are issued into registers before the current
//    tile is computed and stored into the other buffer after it, so loads
//    overlap the FMAs and each tile step has one barrier. Staging through
//    registers, not cp.async, because two operand layouts (A with k
//    contiguous, B^T with k contiguous) must be transposed into the
//    K-major tile on the way. Global loads are 16 bytes along whichever
//    index is contiguous, when the wrapper found the base and the other
//    stride 16-byte aligned; otherwise, and at ragged edges, each element
//    is loaded alone with its bounds test. Blocks walk m fastest, so the
//    blocks in flight share each tile of the larger operand b through L2.
//  * Decode, b n-contiguous (NN, SN: x.W, Mamba's w_x and w_dt at M <= 16):
//    the weight is streamed once. A block owns 32 x V columns (V elements
//    in 16 bytes), each lane V of them, and a K range that its 8 warps
//    share row by row; each lane keeps 4 16-byte loads in flight. The
//    block's M rows of A are staged in shared memory in chunks of 512 k,
//    read as float4 along k; the warps' sums meet in shared memory and
//    are added in warp order.
//  * Decode, b k-contiguous (NT: the tied head h.E^T at decode): a warp
//    owns 4 columns and walks each column's contiguous k with 16-byte
//    loads, 8 in flight per lane, against the staged rows of A; each
//    (column, row) sum closes with a fixed xor-shuffle tree.
// Where the output alone cannot fill the card, K is split over a grid
// dimension: each split writes its fp32 partial sum to a workspace and
// split_sum_kernel adds the splits in order and casts to the output type. No atomics
// anywhere, so every call on the same shapes gives the same bits
// (rematerialization recomputes and expects them).
//
// The batched entry (block_matmul_batched_launch) runs E products of one
// shape, an MoE layer's expert bank (E, C, k) . (E, k, n), in one launch:
// the grid's z dimension walks (expert, K split) pairs, z = e * splits +
// split, each block offsets a, b and out by its expert's batch strides and
// then runs the one-product kernel unchanged. The products are small (C =
// 120 places of DeepSeek's 64 experts at a microbatch of 1024 tokens), so
// one launch per expert would pay 64 launches and 64 partial waves where
// one launch fills the card with E x the tiles of one. The wrapper gives
// the tile paths no K split there (the E products give the grid its
// blocks), so each output element is one fp32 chain over k in order and a
// row's bits do not depend on M: the expert all-to-all's ring and
// blocking forms, which stack the source ranks' rows differently, agree
// bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
};

// V elements at p, p + s, ... as loaded (16 bytes: 4 float32 words, or 8
// bf16 in word halves), 0 at or past `valid`. vec: p is 16-byte aligned
// and s == 1, so a whole group is one load. Widening is left to widen(),
// so that a load in flight is waited for only there.
__device__ __forceinline__ uint32_t bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <typename T>
__device__ __forceinline__ void load_raw(const T* p, int64_t s, int valid,
                                         bool vec, uint32_t* w) {
  constexpr int V = Vec<T>::V, PER = V / 4;  // elements per word
  if (vec && valid >= V) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i < valid) w[i / PER] |= bits(p[i * s]) << (16 * (i % PER));
}
template <typename T>
__device__ __forceinline__ void widen(const uint32_t* w, float* v) {
  if (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// load_raw and widen at once, for data used right away
template <typename T>
__device__ __forceinline__ void load_group(const T* p, int64_t s, int valid,
                                           bool vec, float* v) {
  uint32_t w[4];
  load_raw(p, s, valid, vec, w);
  widen<T>(w, v);
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// ---------------------------------------------------------------------- //
// tiles (M > 16)
// ---------------------------------------------------------------------- //

template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = 16;
  static constexpr int WM = 32, WN = 64;  // one warp's region
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int PAD = 4;  // keeps rows 16-byte aligned
};

using Large = Tile<128, 128>;  // 8 warps
using Mid = Tile<64, 128>;     // 4 warps, for 16 < M <= 64

// One operand's tile, global -> registers -> shared memory stored K-major
// as S[BK][EXT + PAD]; EXT is the tile's extent along m (A) or n (B).
// FAST_K: the operand's contiguous index is k, so a 16-byte group runs
// along k and is transposed on the store; else it runs along the extent
// and is stored as it is. Consecutive threads take consecutive groups of
// a row, so that a warp's loads cover whole 32-byte sectors (FAST_K: 8
// rows of 64 bytes in float32, not 32 rows of 16 bytes, at the price of
// 2-way bank conflicts on the transposing stores).
template <typename T, int EXT, int BK, int THREADS, bool FAST_K>
struct TileLoader {
  static constexpr int V = Vec<T>::V;
  static constexpr int GROUPS = EXT * BK / V / THREADS;  // per thread
  static_assert(GROUPS * V * THREADS == EXT * BK, "tile / thread mismatch");
  uint32_t raw[GROUPS][4];

  __device__ __forceinline__ static void place(int id, int& e, int& k) {
    if (FAST_K) {
      k = (id % (BK / V)) * V;
      e = id / (BK / V);
    } else {
      k = id / (EXT / V);
      e = (id % (EXT / V)) * V;
    }
  }

  // p's element (e, k) is p[e * s_e + k * s_k]; the tile starts at (e0,
  // k0); indices at or past e_end / k_end load as 0
  __device__ __forceinline__ void load(const T* p, int64_t s_e, int64_t s_k,
                                       int e0, int e_end, int k0, int k_end,
                                       bool vec, int tid) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      int e, k;
      place(tid + g * THREADS, e, k);
      e += e0;
      k += k0;
      const T* q = p + (int64_t)e * s_e + (int64_t)k * s_k;
      const int valid = FAST_K ? (e < e_end ? min(V, k_end - k) : 0)
                               : (k < k_end ? min(V, e_end - e) : 0);
      load_raw(q, FAST_K ? s_k : s_e, valid, vec, raw[g]);
    }
  }

  __device__ __forceinline__ void store(float (*S)[EXT + 4], int tid) const {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      int e, k;
      place(tid + g * THREADS, e, k);
      float v[V];
      widen<T>(raw[g], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (FAST_K) {
          S[k + i][e] = v[i];
        } else if (i % 4 == 0) {
          *reinterpret_cast<float4*>(&S[k][e + i]) =
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
        }
      }
    }
  }
};

// a (M, K) through strides (sa_m, sa_k); b (K, N) through (sb_k, sb_n).
// A_K1: a's k stride is 1 (else its m index is taken as the contiguous
// one); B_N1: b's n stride is 1 (else its k index). vec bit 0: a may be
// read 16 bytes at a time along that index, bit 1: b. Block z sums k in
// [z * k_split, (z + 1) * k_split); work != null: write the fp32 partial
// sums to work + z * M * N, else the result to out (type O: T, or float
// for bf16 T). Two blocks per SM
// cap a thread at 128 registers; NT (both operands transposed on their
// way into shared memory) runs faster with the cap lifted.
template <typename T, typename O, typename C, bool A_K1, bool B_N1>
__global__ void __launch_bounds__(C::THREADS, A_K1 && !B_N1 ? 1 : 2)
sgemm_tile_kernel(const T* __restrict__ a, int64_t sa_m, int64_t sa_k,
                  const T* __restrict__ b, int64_t sb_k, int64_t sb_n,
                  O* __restrict__ out, float* __restrict__ work, int M, int N,
                  int K, int k_split, int splits, int64_t sa_e, int64_t sb_e,
                  int vec) {
  constexpr int BK = C::BK;
  __shared__ __align__(16) float As[2][BK][C::BM + C::PAD];
  __shared__ __align__(16) float Bs[2][BK][C::BN + C::PAD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp % C::WARPS_M) * C::WM;
  const int wn = (warp / C::WARPS_M) * C::WN;
  const int ly = lane / 8, lx = lane % 8;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  // grid z walks (batch e, K split): z = e * splits + split
  const int e = blockIdx.z / splits;
  a += e * sa_e;
  b += e * sb_e;
  out += (int64_t)e * M * N;
  const int k_begin = (blockIdx.z % splits) * k_split;
  const int k_end = min(K, k_begin + k_split);
  const bool vec_a = vec & 1, vec_b = vec & 2;

  TileLoader<T, C::BM, BK, C::THREADS, A_K1> la;
  TileLoader<T, C::BN, BK, C::THREADS, !B_N1> lb;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int k0 = k_begin;
  if (k0 < k_end) {
    la.load(a, sa_m, sa_k, m0, M, k0, k_end, vec_a, tid);
    lb.load(b, sb_n, sb_k, n0, N, k0, k_end, vec_b, tid);
    la.store(As[0], tid);
    lb.store(Bs[0], tid);
  }
  __syncthreads();
  for (int buf = 0; k0 < k_end; k0 += BK, buf ^= 1) {
    const bool more = k0 + BK < k_end;
    if (more) {  // in flight while this tile is computed
      la.load(a, sa_m, sa_k, m0, M, k0 + BK, k_end, vec_a, tid);
      lb.load(b, sb_n, sb_k, n0, N, k0 + BK, k_end, vec_b, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[8], br[8];
      load4(&As[buf][kk][wm + ly * 4], ar);
      load4(&As[buf][kk][wm + 16 + ly * 4], ar + 4);
      load4(&Bs[buf][kk][wn + lx * 4], br);
      load4(&Bs[buf][kk][wn + 32 + lx * 4], br + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (more) {
      la.store(As[buf ^ 1], tid);
      lb.store(Bs[buf ^ 1], tid);
    }
    __syncthreads();
  }

  // thread row i: wm + ly * 4 + i % 4 + 16 * (i / 4); column j likewise
  // with lx and 32
  const bool vec_out = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + wm + ly * 4 + i % 4 + 16 * (i / 4);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + wn + lx * 4 + 32 * h;
      const int64_t off = (int64_t)gm * N + gn;
      if (work != nullptr) {
        float* dst = work + (int64_t)blockIdx.z * M * N + off;
        if (vec_out && gn + 3 < N) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) dst[j] = acc[i][4 * h + j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) store(out + off + j, acc[i][4 * h + j]);
      }
    }
  }
}

// ---------------------------------------------------------------------- //
// decode (M <= 16): stream the weight once
// ---------------------------------------------------------------------- //

constexpr int GEMV_WARPS = 8, GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int KC = 512;  // k rows of A staged in shared memory at a time

// As[m][r] = a[m, kc + r] for m < M and r < rows, else 0, for m < MT and
// r < KC. vec_a: a's k stride is 1 and rows start 16-byte aligned.
template <typename T, int MT>
__device__ __forceinline__ void stage_a(float (*As)[KC], const T* a,
                                        int64_t sa_m, int64_t sa_k, int M,
                                        int kc, int rows, bool vec_a,
                                        int tid) {
  constexpr int V = Vec<T>::V;
  for (int id = tid; id < MT * KC / V; id += GEMV_THREADS) {
    const int m = id / (KC / V), r = (id % (KC / V)) * V;
    float v[V];
    load_group(a + (int64_t)m * sa_m + (int64_t)(kc + r) * sa_k, sa_k,
               m < M ? min(V, rows - r) : 0, vec_a, v);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(&As[m][r + i]) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// b n-contiguous. Block (x, z): columns [x * 32V, (x + 1) * 32V), k in
// [z * k_split, ...); warp w takes rows w*U.. of every 8U. out/work as in
// sgemm_tile_kernel.
template <typename T, typename O, int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_n_kernel(const T* __restrict__ a, int64_t sa_m, int64_t sa_k,
              const T* __restrict__ b, int64_t sb_k, int64_t sb_n,
              O* __restrict__ out, float* __restrict__ work, int M, int N,
              int K, int k_split, int splits, int64_t sa_e, int64_t sb_e,
              int vec) {
  constexpr int V = Vec<T>::V, U = 4, COLS = 32 * V;
  __shared__ __align__(16) float As[MT][KC];
  __shared__ float red[GEMV_WARPS][COLS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = blockIdx.x * COLS + lane * V;
  const int e = blockIdx.z / splits;  // z = e * splits + split
  a += e * sa_e;
  b += e * sb_e;
  out += (int64_t)e * M * N;
  const int k_begin = (blockIdx.z % splits) * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_valid = min(V, N - n);
  const bool vec_a = (vec & 1) && sa_k == 1, vec_b = (vec & 2) && sb_n == 1;

  float acc[MT][V];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int rows = min(KC, k_end - kc);
    stage_a<T, MT>(As, a, sa_m, sa_k, M, kc, rows, vec_a, tid);
    __syncthreads();
#pragma unroll 2
    for (int r = warp * U; r < rows; r += GEMV_WARPS * U) {
      float w[U][V];
#pragma unroll
      for (int j = 0; j < U; ++j)
        load_group(b + (int64_t)(kc + r + j) * sb_k + (int64_t)n * sb_n,
                   sb_n, r + j < rows ? n_valid : 0, vec_b, w[j]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float av[U];
        load4(&As[m][r], av);
#pragma unroll
        for (int j = 0; j < U; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][v] = fmaf(av[j], w[j][v], acc[m][v]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;  // uniform over the block
#pragma unroll
    for (int v = 0; v < V; ++v) red[warp][lane * V + v] = acc[m][v];
    __syncthreads();
    for (int c = tid; c < COLS; c += GEMV_THREADS) {
      const int gn = blockIdx.x * COLS + c;
      if (gn < N) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < GEMV_WARPS; ++w) s += red[w][c];
        const int64_t off = (int64_t)m * N + gn;
        if (work != nullptr) {
          work[(int64_t)blockIdx.z * M * N + off] = s;
        } else {
          store(out + off, s);
        }
      }
    }
    __syncthreads();
  }
}

// b k-contiguous. Block (x, z): warp w owns columns x * 8G + w * G + g, g
// < G, k in [z * k_split, ...); lane l reads k groups l*V + i * 32V.
template <typename T, typename O, int MT>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_k_kernel(const T* __restrict__ a, int64_t sa_m, int64_t sa_k,
              const T* __restrict__ b, int64_t sb_k, int64_t sb_n,
              O* __restrict__ out, float* __restrict__ work, int M, int N,
              int K, int k_split, int splits, int64_t sa_e, int64_t sb_e,
              int vec) {
  constexpr int V = Vec<T>::V, G = 4, U = 2, STEP = 32 * V;
  __shared__ __align__(16) float As[MT][KC];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = (blockIdx.x * GEMV_WARPS + warp) * G;
  const int e = blockIdx.z / splits;  // z = e * splits + split
  a += e * sa_e;
  b += e * sb_e;
  out += (int64_t)e * M * N;
  const int k_begin = (blockIdx.z % splits) * k_split;
  const int k_end = min(K, k_begin + k_split);
  const bool vec_a = (vec & 1) && sa_k == 1, vec_b = (vec & 2) && sb_k == 1;

  float acc[G][MT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[g][m] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int rows = min(KC, k_end - kc);
    stage_a<T, MT>(As, a, sa_m, sa_k, M, kc, rows, vec_a, tid);
    __syncthreads();
    for (int r0 = lane * V; r0 < rows; r0 += STEP * U) {
      float w[U][G][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int r = r0 + u * STEP, col = n0 + g;
          load_group(b + (int64_t)col * sb_n + (int64_t)(kc + r) * sb_k, sb_k,
                     col < N ? min(V, rows - r) : 0, vec_b, w[u][g]);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * STEP;
        if (r >= rows) break;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float av[V];
#pragma unroll
          for (int i = 0; i < V; i += 4) load4(&As[m][r + i], av + i);
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[g][m] = fmaf(av[v], w[u][g][v], acc[g][m]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        acc[g][m] += __shfl_xor_sync(0xffffffffu, acc[g][m], o);
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int gn = n0 + g;
      if (gn >= N) break;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= M) break;
        const int64_t off = (int64_t)m * N + gn;
        if (work != nullptr) {
          work[(int64_t)blockIdx.z * M * N + off] = acc[g][m];
        } else {
          store(out + off, acc[g][m]);
        }
      }
    }
  }
}

// out[e * n + i] = sum over s of work[(e * splits + s) * n + i], s in
// order, for each of `batch` products of n outputs; cast to O.
template <typename O>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ work, O* __restrict__ out,
                 int64_t n, int splits, int batch) {
  const int64_t total = n * batch;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i / n, j = i % n;
    const float* w = work + e * splits * n + j;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += w[z * n];
    store(out + i, s);
  }
}

// ---------------------------------------------------------------------- //
// dispatch
// ---------------------------------------------------------------------- //

enum Path { kLarge = 0, kMid = 1, kDecodeN = 2, kDecodeK = 3 };

// k_split must be a multiple of this (and so of the loaders' groups)
template <typename T>
int k_granule(int path) {
  if (path == kDecodeN) return 32;                    // 8 warps x 4 rows
  if (path == kDecodeK) return 2 * 32 * Vec<T>::V;    // U x STEP
  return 16;                                          // the tiles' BK
}

struct Args {
  const void* a;
  int64_t sa_e, sa_m, sa_k;
  const void* b;
  int64_t sb_e, sb_k, sb_n;
  void* out;
  float* work;
  int E, M, N, K, splits, k_split, vec;
  cudaStream_t s;
};

template <typename T, typename O, typename C, bool A_K1, bool B_N1>
void launch_tile(const Args& g) {
  const dim3 grid((g.M + C::BM - 1) / C::BM, (g.N + C::BN - 1) / C::BN,
                  g.E * g.splits);
  sgemm_tile_kernel<T, O, C, A_K1, B_N1><<<grid, C::THREADS, 0, g.s>>>(
      static_cast<const T*>(g.a), g.sa_m, g.sa_k,
      static_cast<const T*>(g.b), g.sb_k, g.sb_n, static_cast<O*>(g.out),
      g.splits > 1 ? g.work : nullptr, g.M, g.N, g.K, g.k_split, g.splits,
      g.sa_e, g.sb_e, g.vec);
}

template <typename T, typename O, typename C>
void launch_tiles(const Args& g) {
  const bool a_k1 = g.sa_k == 1, b_n1 = g.sb_n == 1;
  if (a_k1 && b_n1) {
    launch_tile<T, O, C, true, true>(g);
  } else if (a_k1) {
    launch_tile<T, O, C, true, false>(g);
  } else if (b_n1) {
    launch_tile<T, O, C, false, true>(g);
  } else {
    launch_tile<T, O, C, false, false>(g);
  }
}

template <typename T, typename O, int MT>
void launch_gemv(const Args& g, int path) {
  const T* pa = static_cast<const T*>(g.a);
  const T* pb = static_cast<const T*>(g.b);
  O* po = static_cast<O*>(g.out);
  float* pw = g.splits > 1 ? g.work : nullptr;
  if (path == kDecodeN) {
    const int cols = 32 * Vec<T>::V;
    const dim3 grid((g.N + cols - 1) / cols, 1, g.E * g.splits);
    gemv_n_kernel<T, O, MT><<<grid, GEMV_THREADS, 0, g.s>>>(
        pa, g.sa_m, g.sa_k, pb, g.sb_k, g.sb_n, po, pw, g.M, g.N, g.K,
        g.k_split, g.splits, g.sa_e, g.sb_e, g.vec);
  } else {
    const int cols = GEMV_WARPS * 4;
    const dim3 grid((g.N + cols - 1) / cols, 1, g.E * g.splits);
    gemv_k_kernel<T, O, MT><<<grid, GEMV_THREADS, 0, g.s>>>(
        pa, g.sa_m, g.sa_k, pb, g.sb_k, g.sb_n, po, pw, g.M, g.N, g.K,
        g.k_split, g.splits, g.sa_e, g.sb_e, g.vec);
  }
}

template <typename T, typename O>
int launch(const Args& g, int path) {
  if (g.k_split % k_granule<T>(path)) return (int)cudaErrorInvalidValue;
  if (path == kLarge) {
    launch_tiles<T, O, Large>(g);
  } else if (path == kMid) {
    launch_tiles<T, O, Mid>(g);
  } else if (g.M <= 4) {
    launch_gemv<T, O, 4>(g, path);
  } else if (g.M <= 8) {
    launch_gemv<T, O, 8>(g, path);
  } else if (g.M <= 16) {
    launch_gemv<T, O, 16>(g, path);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (g.splits > 1) {
    const int64_t n = (int64_t)g.M * g.N;
    const int64_t want = (n * g.E + 255) / 256;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    split_sum_kernel<O><<<blocks, 256, 0, g.s>>>(
        g.work, static_cast<O*>(g.out), n, g.splits, g.E);
  }
  return (int)cudaGetLastError();
}

// whether p + i * stride for every i can be read 16 bytes at a time
bool aligned16(const void* p, int64_t stride, int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride * elt) % 16 == 0;
}

}  // namespace

// E products out[e] (M, N) = a[e] (M, K) @ b[e] (K, N) in one launch: a[e]
// starts sa_e elements after a[e - 1], b[e] sb_e after b[e - 1], and out is
// (E, M, N) row-major. The batch rides the grid's z dimension beside the K
// split (z = e * splits + split), so every product runs the plan of one
// (M, N, K) product. dtype: 0 = float32, 1 = bfloat16 (a and b share it);
// out_dtype: the same, or 0 (float32) for bfloat16 operands. path: 0 the
// 128 x 128 tile, 1 the 64 x 128 tile, 2 decode with b's n index
// contiguous, 3 decode with b's k index contiguous (M <= 16 for 2 and 3).
// vec bit 0 (1): read a 16 bytes at a time along its contiguous index, bit
// 1 (2): b; the base, the other stride and the batch stride must be
// 16-byte aligned. splits > 1 needs work: E * splits * M * N floats, and
// k_split a multiple of the path's granule (16 for the tiles, 32 for path
// 2, 256 (float32) or 512 (bf16) for path 3) with (splits - 1) * k_split
// < K. Returns a cudaError_t (cudaGetLastError() after the launches).
extern "C" int block_matmul_batched_launch(
    const void* a, long long sa_e, long long sa_m, long long sa_k,
    const void* b, long long sb_e, long long sb_k, long long sb_n, void* out,
    void* work, int E, int M, int N, int K, int splits, int k_split,
    int path, int vec, int dtype, int out_dtype, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const int elt = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 1 || (out_dtype != dtype && out_dtype != 0) ||
      path < 0 || path > 3 || splits < 1 || (long long)E * splits > 65535 ||
      k_split <= 0 || (long long)(splits - 1) * k_split >= (K > 0 ? K : 1) ||
      (splits > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // a 16-byte group runs along the index whose stride is 1; the other
  // stride steps between groups, the batch stride between products
  if (((vec & 1) && !((sa_k == 1 ? aligned16(a, sa_m, elt)
                                 : sa_m == 1 && aligned16(a, sa_k, elt)) &&
                      aligned16(a, sa_e, elt))) ||
      ((vec & 2) && !((sb_n == 1 ? aligned16(b, sb_k, elt)
                                 : sb_k == 1 && aligned16(b, sb_n, elt)) &&
                      aligned16(b, sb_e, elt)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args g{a,   sa_e, sa_m, sa_k, b,     sb_e, sb_k,    sb_n,
               out, static_cast<float*>(work), E, M, N, K, splits, k_split,
               vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float, float>(g, path);
  return out_dtype == 0 ? launch<__nv_bfloat16, float>(g, path)
                        : launch<__nv_bfloat16, __nv_bfloat16>(g, path);
}

// One product: block_matmul_batched_launch with E = 1. out is (M, N)
// row-major; splits > 1 needs work: splits * M * N floats.
extern "C" int block_matmul_launch(const void* a, long long sa_m,
                                   long long sa_k, const void* b,
                                   long long sb_k, long long sb_n, void* out,
                                   void* work, int M, int N, int K,
                                   int splits, int k_split, int path,
                                   int vec, int dtype, int out_dtype,
                                   void* stream) {
  return block_matmul_batched_launch(a, 0, sa_m, sa_k, b, 0, sb_k, sb_n, out,
                                     work, 1, M, N, K, splits, k_split, path,
                                     vec, dtype, out_dtype, stream);
}
