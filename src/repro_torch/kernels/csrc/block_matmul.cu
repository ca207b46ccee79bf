// K1, the local GEMM for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/block_matmul.py:block_matmul (Pallas body
// `_kernel`), the local GEMM of paper Algorithm 1 (lines 6/13):
//     out (M, N) = a (M, K) @ b (K, N)
// with fp32 accumulation across K and the output in the inputs' dtype, as
// repro.core.parallel._mm computes it. Each operand comes with its own row
// and column strides, so the three layouts of training run without copies:
// X.W (NN), dY.W^T and h.E^T (NT, b read through a transposed view), and
// X^T.dY (TN, a read through a transposed view).
//
// What bounds it: at the training shapes (M = 1024 tokens, K and N in the
// thousands) operations: 2MNK of them against (MK + KN + MN) elements
// moved is hundreds of operations per byte, above the card's ridge. The
// float32 path stays float32 (no TF32), so the bound is the 67 TFLOP/s of
// the CUDA cores, not the tensor cores. At the serving decode shape
// (M = 8 rows) it is bytes: each weight element is read once for 16
// operations.
//
// Design, simple first:
//  * one block per output tile; operand tiles pass through shared memory
//    as fp32 (bf16 widens on load) and each thread keeps a register
//    micro-tile of fp32 FMA accumulators. Rows and columns of a thread's
//    micro-tile are strided by the thread grid, so its shared-memory reads
//    are broadcasts or consecutive words (no bank conflicts), and the
//    tiles are stored K-major with 4 words of padding, so that the
//    coalesced stores of either operand layout do not conflict either;
//  * the tile height follows M: 128 x 128 tiles (8 x 8 per thread) for the
//    training and prefill shapes, 16 x 64 tiles for M <= 64 (decode has M
//    = 8, where a 128-row tile would waste 15/16 of its work);
//  * where the output tiles alone cannot fill the card, K is split over
//    gridDim.z: each split writes its fp32 partial sum to a workspace and
//    a second kernel adds the splits in a fixed order and casts. No
//    atomics, so every call on the same shapes gives the same bits
//    (rematerialization recomputes and expects them).
// The wrapper (kernels/block_matmul.py) chooses the tile and the split.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TY = BM / TM, TX = BN / TN, THREADS = TY * TX;
  static constexpr int PAD = 4;
};

using Large = Tile<128, 128, 8, 8, 8>;  // 16 x 16 threads
using Small = Tile<16, 64, 32, 1, 4>;   // 16 x 16 threads

// a (M, K) through strides (sa_m, sa_k); b (K, N) through (sb_k, sb_n).
// A_K1: a's k stride is 1 (else its m stride is taken as the fast one);
// B_N1: b's n stride is 1 (else its k stride). They only choose which
// index consecutive threads walk on loads, so that loads coalesce; any
// strides give the right result. Block z sums k in [z * k_split,
// (z + 1) * k_split). SPLIT: write fp32 partials to out + z * M * N.
template <typename T, typename C, bool A_K1, bool B_N1, bool SPLIT>
__global__ void __launch_bounds__(C::THREADS, 2)
gemm_kernel(const T* __restrict__ a, int64_t sa_m, int64_t sa_k,
            const T* __restrict__ b, int64_t sb_k, int64_t sb_n,
            void* __restrict__ out, int M, int N, int K, int k_split) {
  __shared__ float As[C::BK][C::BM + C::PAD];
  __shared__ float Bs[C::BK][C::BN + C::PAD];
  const int tid = threadIdx.x;
  const int tx = tid % C::TX, ty = tid / C::TX;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += C::BK) {
#pragma unroll
    for (int e = tid; e < C::BM * C::BK; e += C::THREADS) {
      const int mm = A_K1 ? e / C::BK : e % C::BM;
      const int kk = A_K1 ? e % C::BK : e / C::BM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < k_end) ? to_f(a[gm * sa_m + gk * sa_k])
                                          : 0.f;
    }
#pragma unroll
    for (int e = tid; e < C::BK * C::BN; e += C::THREADS) {
      const int nn = B_N1 ? e % C::BN : e / C::BK;
      const int kk = B_N1 ? e / C::BN : e % C::BK;
      const int gn = n0 + nn, gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < k_end) ? to_f(b[gk * sb_k + gn * sb_n])
                                          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      float ar[C::TM], br[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) ar[i] = As[kk][ty + i * C::TY];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) br[j] = Bs[kk][tx + j * C::TX];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gm = m0 + ty + i * C::TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int gn = n0 + tx + j * C::TX;
      if (gn >= N) continue;
      const int64_t off = (int64_t)gm * N + gn;
      if (SPLIT) {
        static_cast<float*>(out)[(int64_t)blockIdx.z * M * N + off] =
            acc[i][j];
      } else {
        store(static_cast<T*>(out) + off, acc[i][j]);
      }
    }
  }
}

// out[i] = sum over s of work[s * n + i], s in order; cast to T.
template <typename T>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ work, T* __restrict__ out,
                 int64_t n, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[z * n + i];
    store(out + i, s);
  }
}

template <typename T, typename C, bool A_K1, bool B_N1>
void launch_tile(const void* a, int64_t sa_m, int64_t sa_k, const void* b,
                 int64_t sb_k, int64_t sb_n, void* out, void* work, int M,
                 int N, int K, int splits, int k_split, cudaStream_t s) {
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  if (splits == 1) {
    gemm_kernel<T, C, A_K1, B_N1, false><<<grid, C::THREADS, 0, s>>>(
        pa, sa_m, sa_k, pb, sb_k, sb_n, out, M, N, K, k_split);
    return;
  }
  gemm_kernel<T, C, A_K1, B_N1, true><<<grid, C::THREADS, 0, s>>>(
      pa, sa_m, sa_k, pb, sb_k, sb_n, work, M, N, K, k_split);
  const int64_t n = (int64_t)M * N;
  const int64_t want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  split_sum_kernel<T><<<blocks, 256, 0, s>>>(static_cast<const float*>(work),
                                             static_cast<T*>(out), n, splits);
}

template <typename T, typename C>
void launch_layout(const void* a, int64_t sa_m, int64_t sa_k, const void* b,
                   int64_t sb_k, int64_t sb_n, void* out, void* work, int M,
                   int N, int K, int splits, int k_split, cudaStream_t s) {
  const bool a_k1 = sa_k == 1, b_n1 = sb_n == 1;
#define K1_ARGS a, sa_m, sa_k, b, sb_k, sb_n, out, work, M, N, K, splits, \
                k_split, s
  if (a_k1 && b_n1) {
    launch_tile<T, C, true, true>(K1_ARGS);
  } else if (a_k1) {
    launch_tile<T, C, true, false>(K1_ARGS);
  } else if (b_n1) {
    launch_tile<T, C, false, true>(K1_ARGS);
  } else {
    launch_tile<T, C, false, false>(K1_ARGS);
  }
#undef K1_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it). out is (M, N)
// row-major. small: 1 for the 16 x 64 tile (M <= 64), 0 for 128 x 128.
// splits > 1 needs work: splits * M * N floats, and k_split a multiple of
// the tile's depth (8 for the large tile, 32 for the small one) with
// (splits - 1) * k_split < K. Returns cudaGetLastError().
extern "C" int block_matmul_launch(const void* a, long long sa_m,
                                   long long sa_k, const void* b,
                                   long long sb_k, long long sb_n, void* out,
                                   void* work, int M, int N, int K,
                                   int splits, int k_split, int small,
                                   int dtype, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int bk = small ? Small::BK : Large::BK;
  if (splits < 1 || k_split <= 0 || k_split % bk ||
      (long long)(splits - 1) * k_split >= (K > 0 ? K : 1) ||
      (splits > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_ARGS a, sa_m, sa_k, b, sb_k, sb_n, out, work, M, N, K, splits, \
                k_split, s
  if (dtype == 0 && small) {
    launch_layout<float, Small>(K1_ARGS);
  } else if (dtype == 0) {
    launch_layout<float, Large>(K1_ARGS);
  } else if (dtype == 1 && small) {
    launch_layout<__nv_bfloat16, Small>(K1_ARGS);
  } else if (dtype == 1) {
    launch_layout<__nv_bfloat16, Large>(K1_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef K1_ARGS
  return (int)cudaGetLastError();
}
