// K5, paged variable-length attention for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_paged
// (Pallas body `_paged_kernel`), whose function the JAX serving path
// computes in jnp as a page gather plus
// repro.layers.attention.paged_attn_core. For each request slot r, query
// row t and query head hq (KV head hq / g):
//     out = softmax_j(q . k_j * scale, masked) @ v_j
// over the keys j that slot r's page table maps, with key j at global
// position j. A key counts when it is at or before the row's q_pos (and
// inside the window, if one is set) and the row is below q_len[r]. Under
// the mask p is exactly 0, so null and stale pages add nothing; a row with
// no valid key writes 0.
//
// What bounds it: memory. Decode reads each slot's K and V pages once per
// KV head group and does 4 * g operations per loaded element (g = query
// heads per KV head), below the card's operations-per-byte ridge; chunked
// prefill does 4 * g * T, still small for the chunk sizes served.
//
// Design, simple first:
//  * one block per (slot, KV head, tile of 16 query rows). The rows of a
//    tile are the (t, head-in-group) pairs of that KV head, so every K/V
//    page a block loads serves all g query heads of the group;
//  * the block reads its own row of the page table (the TPU kernel's
//    scalar prefetch) and walks the pages in order in a loop (the TPU
//    kernel's sequential grid axis). It stops after the last page that
//    holds a key at or before its largest valid q_pos: a page wholly past
//    every row's causal limit leaves each row's (m, l, acc) bitwise
//    unchanged, so skipping it changes no bit;
//  * each page's K (rows padded by one float, so that lane j reading key
//    j hits bank j) and V go to shared memory as fp32;
//  * one warp per query row: lane j scores key j with a sequential fp32
//    dot product over head_dim, the page's max and sum are warp
//    butterflies, and each lane carries head_dim / 32 accumulator columns.
//    The (m, l, acc) carry is fp32, updated once per page as in the TPU
//    kernel.
// Every row runs the same instructions in the same order whatever T is and
// wherever the row sits in its chunk, so chunked prefill equals one-shot
// prefill bitwise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxPage = 32;                  // one lane per key
constexpr float kNegInf = -1e30f;             // NEG_INF of the JAX package

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q: (R, T, nq, HD) through strides (q_sr, q_st, q_sh; unit stride in HD).
// kpool, vpool: (P, page, nkv, HD) contiguous. table: (R, n_pages) int32.
// q_pos: (R, T) int32. q_len: (R,) int32. out: (R, T, nq, HD) contiguous.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_st,
                       int64_t q_sh, const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const int* __restrict__ table,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ q_len, T* __restrict__ out,
                       int n_t, int nq, int nkv, int n_pages, int page,
                       int n_phys, int window, float scale) {
  constexpr int kCols = HD / 32;  // accumulator columns per lane
  __shared__ float q_s[kRows * HD];
  __shared__ float k_s[kMaxPage * (HD + 1)];
  __shared__ float v_s[kMaxPage * HD];
  __shared__ int s_n_iter;

  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int g = nq / nkv;
  const int n_rows = n_t * g;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qlen = q_len[r];

  // stage this tile's query rows as fp32; local row i is (t, gi) =
  // divmod(row0 + i, g), query head h * g + gi
  for (int e = threadIdx.x; e < kRows * HD; e += blockDim.x) {
    const int row = row0 + e / HD;
    float val = 0.f;
    if (row < n_rows) {
      const int t = row / g, hq = h * g + row % g;
      val = to_f(q[r * q_sr + t * q_st + hq * q_sh + e % HD]);
    }
    q_s[e] = val;
  }
  if (threadIdx.x == 0) {
    int max_pos = -1;
    for (int i = 0; i < kRows && row0 + i < n_rows; ++i) {
      const int t = (row0 + i) / g;
      if (t < qlen) max_pos = max(max_pos, q_pos[r * n_t + t]);
    }
    s_n_iter = max_pos < 0 ? 0 : min(max_pos / page + 1, n_pages);
  }
  __syncthreads();
  const int n_iter = s_n_iter;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int pos[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kWarps;
    const int t = row / g;
    live[i] = row < n_rows && t < qlen;  // uniform across the warp
    pos[i] = live[i] ? q_pos[r * n_t + t] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int pi = 0; pi < n_iter; ++pi) {
    int pid = table[r * n_pages + pi];
    pid = min(max(pid, 0), n_phys - 1);  // clamped, as a jnp gather clamps
    const int64_t base = (int64_t)pid * page * nkv * HD + (int64_t)h * HD;
    for (int e = threadIdx.x; e < page * HD; e += blockDim.x) {
      const int j = e / HD, d = e % HD;
      const int64_t off = base + (int64_t)j * nkv * HD + d;
      k_s[j * (HD + 1) + d] = to_f(kpool[off]);
      v_s[j * HD + d] = to_f(vpool[off]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (!live[i]) continue;
      const int kpos = pi * page + lane;
      const bool ok = lane < page && pos[i] >= kpos &&
                      (window <= 0 || pos[i] - kpos < window);
      float s = kNegInf;
      if (ok) {
        const float* qr = q_s + (warp + i * kWarps) * HD;
        const float* kr = k_s + lane * (HD + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float pv = 0.f;
        for (int j = 0; j < page; ++j)
          pv += __shfl_sync(0xffffffffu, p, j) * v_s[j * HD + c * 32 + lane];
        acc[i][c] = alpha * acc[i][c] + pv;
      }
      m[i] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kWarps;
    if (row >= n_rows) continue;
    const int t = row / g, hq = h * g + row % g;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + (((int64_t)r * n_t + t) * nq + hq) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(o + c * 32 + lane, acc[i][c] * inv);
  }
}

template <typename T, int HD>
void launch(const void* q, long long q_sr, long long q_st, long long q_sh,
            const void* kpool, const void* vpool, const void* table,
            const void* q_pos, const void* q_len, void* out, int n_slots,
            int n_t, int nq, int nkv, int n_pages, int page, int n_phys,
            int window, float scale, cudaStream_t s) {
  const int tiles = (n_t * (nq / nkv) + kRows - 1) / kRows;
  const dim3 grid(n_slots, nkv, tiles);
  paged_attention_kernel<T, HD><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), q_sr, q_st, q_sh,
      static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const int*>(q_len), static_cast<T*>(out), n_t, nq, nkv,
      n_pages, page, n_phys, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). head_dim
// 64 or 128; page <= 32. Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, long long q_sr, long long q_st, long long q_sh,
    const void* kpool, const void* vpool, const void* table,
    const void* q_pos, const void* q_len, void* out, int n_slots, int n_t,
    int nq, int nkv, int head_dim, int n_pages, int page, int n_phys,
    int window, float scale, int dtype, void* stream) {
  if (n_slots <= 0 || n_t <= 0) return 0;
  if (page <= 0 || page > kMaxPage || nkv <= 0 || nq % nkv) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_ARGS q, q_sr, q_st, q_sh, kpool, vpool, table, q_pos, q_len, out, \
                n_slots, n_t, nq, nkv, n_pages, page, n_phys, window, scale, s
  if (dtype == 0 && head_dim == 128) {
    launch<float, 128>(K5_ARGS);
  } else if (dtype == 0 && head_dim == 64) {
    launch<float, 64>(K5_ARGS);
  } else if (dtype == 1 && head_dim == 128) {
    launch<__nv_bfloat16, 128>(K5_ARGS);
  } else if (dtype == 1 && head_dim == 64) {
    launch<__nv_bfloat16, 64>(K5_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef K5_ARGS
  return (int)cudaGetLastError();
}
