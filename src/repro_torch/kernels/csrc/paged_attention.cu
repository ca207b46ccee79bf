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
// no valid key writes 0. Page table entries are clamped to [0, n_phys);
// bf16 widens to fp32.
//
// What bounds it: memory. Decode reads each slot's K and V pages once per
// KV head group and does 4 * g operations per loaded element (g = query
// heads per KV head), below the card's operations-per-byte ridge; chunked
// prefill does 4 * g * T, still small for the chunk sizes served.
//
// Design: a split page walk (flash decoding) in two kernels.
//  * The keys are cut into splits of split_pages(page) pages, at most
//    kSplitKeys keys. The boundaries are a function of the key position
//    and the page size alone, never of T, the chunk, the slots or the
//    grid.
//  * paged_split_kernel: one block of 4 warps per (slot, KV head, split,
//    tile of 16 query rows). The rows of a tile are the (t, head-in-group)
//    pairs of that KV head, so every K/V row a block loads serves all g
//    query heads of the group. Warp w takes keys [16 w, 16 w + 16) of the
//    split; each lane holds head_dim / 32 elements of each of its 16 K and
//    V rows, all 32 loads issued at once (16 bytes a lane for float32 at
//    head_dim 128). A (row, key) score is a parallel dot product: each
//    lane's share, then a reduce-scatter across the lanes (15 shuffles for
//    16 keys, and one across the half-warps) leaves lane l with key l % 16.
//    The scores meet in shared memory; each row's max and sum are warp
//    butterflies over the split's keys; each warp sums p v over its own
//    keys, and the four warps' sums are added in warp order. The split's
//    (m, l, acc) per row go to a workspace in fp32. A block whose rows see
//    no key of its split returns at once, and keys that no row of the
//    block sees are not loaded.
//  * paged_combine_kernel: one warp per (slot, row, query head) merges the
//    row's splits in ascending order, from the first split its window
//    reaches to the last that holds a key at or before its q_pos, and
//    divides by l. A row's bits so depend only on its own keys. Where the
//    caller asks for it, the row's log-sum-exp m + log l goes to lse
//    (NEG_INF for a row with no key): the merge of partial softmaxes over
//    shards of a long cache (flash decoding across ranks) needs it. A
//    query position below 0 reads no key (l = 0); one past the table sees
//    every key of it.
// Every row runs the same instructions in the same order whatever T is and
// wherever the row sits in its chunk or tile, and no kernel uses atomics,
// so chunked prefill equals one-shot prefill bitwise and repeated calls
// give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerWarp = 16;
constexpr int kSplitKeys = kWarps * kKeysPerWarp;  // most keys of a split
constexpr int kRows = 16;                          // query rows per block
constexpr int kMaxPage = 32;
constexpr int kCombineWarps = 8;
constexpr float kNegInf = -1e30f;                  // NEG_INF of the JAX package

static_assert(kMaxPage <= kSplitKeys, "a split holds at least one page");

// pages in a split: as many whole pages as fit in kSplitKeys
__host__ __device__ __forceinline__ int split_pages(int page) {
  return kSplitKeys / page;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a lane's N elements of one K or V row, loaded as one access
template <typename T, int N>
struct __align__(sizeof(T) * N) Pack {
  T v[N];
};

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

// One reduce-scatter step over lanes l and l ^ O: of v[0, 2 O) each lane
// keeps the half its bit O selects, summed with the partner's same half.
template <int O>
__device__ __forceinline__ void halve(float (&v)[kKeysPerWarp], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = up ? v[j] : v[j + O];
    const float keep = up ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// q: (R, T, nq, HD) through strides (q_sr, q_st, q_sh; unit stride in HD).
// kpool, vpool: (P, page, nkv, HD) contiguous. table: (R, n_pages) int32.
// q_pos: (R, T) int32. q_len: (R,) int32. part: the workspace, acc (n_part,
// HD) then (m, l) (n_part, 2), n_part = R * nkv * n_splits * T * g, row
// ((r * nkv + h) * n_splits + split) * T * g + t * g + gi.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_st,
                   int64_t q_sh, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ table,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ q_len, float* __restrict__ part,
                   int n_t, int nq, int nkv, int n_pages, int page,
                   int n_phys, int window, float scale, int n_splits,
                   int n_tiles) {
  constexpr int N = HD / 32;  // elements of a K/V row per lane
  using Row = Pack<T, N>;
  // q_s holds the tile's q rows until the scores are in; the warps' p v
  // sums (acc_s) then take its place
  __shared__ float qa_s[kWarps * kRows * HD];
  float* q_s = qa_s;
  float* acc_s = qa_s;
  __shared__ float s_s[kRows * kSplitKeys];  // scores, then p
  __shared__ float m_s[kRows], l_s[kRows];
  __shared__ int64_t koff_s[kSplitKeys];     // element offset of each key row
  __shared__ int pos_s[kRows];

  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z / n_tiles;
  const int row0 = (blockIdx.z % n_tiles) * kRows;
  const int g = nq / nkv;
  const int n_rows = n_t * g;
  const int n_here = min(kRows, n_rows - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qlen = q_len[r];
  const int split_keys = split_pages(page) * page;
  const int key0 = split * split_keys;
  const int key_end = min(key0 + split_keys, n_pages * page);

  // row i's q_pos, -1 past q_len (its loads do not wait for q_len's)
  auto row_pos = [&](int i) {
    const int t = (row0 + i) / g;
    const int p = i < n_here ? q_pos[r * n_t + t] : -1;
    return t < qlen ? p : -1;
  };
  // the keys some row of the tile sees, [lo, hi], in every thread, so
  // that a block with nothing to do returns before any barrier
  int hi = -1, lo = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = row_pos(i);
    if (p < 0) continue;
    hi = max(hi, p);
    lo = min(lo, window > 0 ? p - window + 1 : 0);
  }
  if (hi < key0 || lo >= key_end) return;  // uniform: no row sees the split
  if (threadIdx.x < kRows) pos_s[threadIdx.x] = row_pos(threadIdx.x);

  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int i = e / HD;
    float val = 0.f;
    if (i < n_here) {
      const int row = row0 + i;
      const int t = row / g, hq = h * g + row % g;
      val = to_f(q[r * q_sr + t * q_st + hq * q_sh + e % HD]);
    }
    q_s[e] = val;
  }
  if (threadIdx.x < kSplitKeys) {
    const int kp = key0 + threadIdx.x;
    int64_t off = -1;
    if (threadIdx.x < split_keys && kp < key_end) {
      int pid = table[r * n_pages + kp / page];
      pid = min(max(pid, 0), n_phys - 1);  // clamped, as a jnp gather clamps
      off = ((int64_t)pid * page + kp % page) * nkv * HD + (int64_t)h * HD;
    }
    koff_s[threadIdx.x] = off;
  }
  __syncthreads();

  // this warp's 16 K and V rows, every load in flight before any is used
  Row kr[kKeysPerWarp], vr[kKeysPerWarp];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int kk = warp * kKeysPerWarp + j;
    const int64_t off = koff_s[kk];
    const int kp = key0 + kk;
    if (off >= 0 && kp <= hi && kp >= lo) {
      kr[j] = *reinterpret_cast<const Row*>(kpool + off + lane * N);
      vr[j] = *reinterpret_cast<const Row*>(vpool + off + lane * N);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        store(&kr[j].v[c], 0.f);
        store(&vr[j].v[c], 0.f);
      }
    }
  }

  // scores: lane shares of q . k, reduce-scattered over the lanes
  for (int i = 0; i < n_here; ++i) {
    if (pos_s[i] < 0) continue;  // uniform: a row past q_len
    float qv[N];
#pragma unroll
    for (int c = 0; c < N; ++c) qv[c] = q_s[i * HD + lane * N + c];
    float v[kKeysPerWarp];
#pragma unroll
    for (int j = 0; j < kKeysPerWarp; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) dot = fmaf(qv[c], to_f(kr[j].v[c]), dot);
      v[j] = dot;
    }
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    const float dot = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
    if (lane < kKeysPerWarp)
      s_s[i * kSplitKeys + warp * kKeysPerWarp + lane] = dot * scale;
  }
  __syncthreads();

  // each row's max and sum over the split's keys; p replaces the score
  for (int i = warp; i < n_here; i += kWarps) {
    const int pos = pos_s[i];
    if (pos < 0) continue;
    float s[2];
    bool ok[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kk = lane + 32 * u, kp = key0 + kk;
      ok[u] = kk < split_keys && kp < key_end && kp <= pos &&
              (window <= 0 || pos - kp < window);
      s[u] = ok[u] ? s_s[i * kSplitKeys + kk] : kNegInf;
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float p = ok[u] ? expf(s[u] - m) : 0.f;
      s_s[i * kSplitKeys + lane + 32 * u] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_s[i] = m;
      l_s[i] = l;
    }
  }
  __syncthreads();

  // p v over this warp's keys, in key order
  for (int i = 0; i < n_here; ++i) {
    if (pos_s[i] < 0) continue;
    float a[N];
#pragma unroll
    for (int c = 0; c < N; ++c) a[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerWarp; ++j) {
      const float p = s_s[i * kSplitKeys + warp * kKeysPerWarp + j];
#pragma unroll
      for (int c = 0; c < N; ++c) a[c] = fmaf(p, to_f(vr[j].v[c]), a[c]);
    }
#pragma unroll
    for (int c = 0; c < N; ++c)
      acc_s[(warp * kRows + i) * HD + lane * N + c] = a[c];
  }
  __syncthreads();

  // the four warps' sums in warp order, and (m, l), to the workspace
  const int64_t n_part = (int64_t)gridDim.x * nkv * n_splits * n_rows;
  const int64_t base = ((int64_t)r * nkv + h) * n_splits + split;
  for (int e = threadIdx.x; e < n_here * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    if (pos_s[i] < 0) continue;
    float a = acc_s[i * HD + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += acc_s[(w * kRows + i) * HD + d];
    part[(base * n_rows + row0 + i) * HD + d] = a;
  }
  if (threadIdx.x < n_here && pos_s[threadIdx.x] >= 0) {
    float* ml = part + n_part * HD + (base * n_rows + row0 + threadIdx.x) * 2;
    ml[0] = m_s[threadIdx.x];
    ml[1] = l_s[threadIdx.x];
  }
}

// out (R, T, nq, HD) contiguous: one warp per (r, t, hq); lse (R, T, nq)
// fp32, or null
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ q_len, T* __restrict__ out,
                     float* __restrict__ lse, int n_slots, int n_t, int nq,
                     int nkv, int window, int split_keys, int n_splits,
                     int key_cap) {
  constexpr int N = HD / 32;
  const int lane = threadIdx.x & 31;
  const int64_t gr = (int64_t)blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (gr >= (int64_t)n_slots * n_t * nq) return;
  const int hq = (int)(gr % nq);
  const int t = (int)(gr / nq % n_t);
  const int r = (int)(gr / ((int64_t)nq * n_t));
  const int g = nq / nkv, n_rows = n_t * g;
  float acc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = 0.f;
  float l = 0.f, m = kNegInf;
  if (t < q_len[r]) {
    // the row's keys are [first, last]: no split outside them is read
    const int pos = q_pos[r * n_t + t];
    const int first = window > 0 ? max(0, pos - window + 1) : 0;
    const int last = min(pos, key_cap - 1);
    const int s_lo = first / split_keys;
    const int s_hi = last < first ? s_lo - 1 : last / split_keys;
    const int64_t n_part = (int64_t)n_slots * nkv * n_splits * n_rows;
    const int64_t row = ((int64_t)r * nkv + hq / g) * n_splits * n_rows +
                        t * g + hq % g;
    for (int s = s_lo; s <= s_hi; ++s) {
      const int64_t idx = row + (int64_t)s * n_rows;
      const float ms = part[n_part * HD + idx * 2];
      const float ls = part[n_part * HD + idx * 2 + 1];
      const float m_new = fmaxf(m, ms);
      const float a = expf(m - m_new), b = expf(ms - m_new);
      l = a * l + b * ls;
#pragma unroll
      for (int c = 0; c < N; ++c)
        acc[c] = a * acc[c] + b * part[idx * HD + lane * N + c];
      m = m_new;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* o = out + gr * HD + lane * N;
#pragma unroll
  for (int c = 0; c < N; ++c) store(o + c, acc[c] * inv);
  if (lse != nullptr && lane == 0) lse[gr] = l > 0.f ? m + logf(l) : kNegInf;
}

int n_splits_of(int n_pages, int page) {
  const int sp = split_pages(page);
  return (n_pages + sp - 1) / sp;
}

template <typename T, int HD>
int launch(const void* q, long long q_sr, long long q_st, long long q_sh,
           const void* kpool, const void* vpool, const void* table,
           const void* q_pos, const void* q_len, void* out, void* lse,
           void* work, int n_slots, int n_t, int nq, int nkv, int n_pages,
           int page, int n_phys, int window, float scale, cudaStream_t s) {
  const int n_splits = n_splits_of(n_pages, page);
  const int tiles = (n_t * (nq / nkv) + kRows - 1) / kRows;
  float* part = static_cast<float*>(work);
  const dim3 grid(n_slots, nkv, n_splits * tiles);
  paged_split_kernel<T, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), q_sr, q_st, q_sh,
      static_cast<const T*>(kpool), static_cast<const T*>(vpool),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const int*>(q_len), part, n_t, nq, nkv, n_pages, page,
      n_phys, window, scale, n_splits, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)n_slots * n_t * nq;
  const unsigned blocks = (unsigned)((rows + kCombineWarps - 1) /
                                     kCombineWarps);
  paged_combine_kernel<T, HD><<<blocks, kCombineWarps * 32, 0, s>>>(
      part, static_cast<const int*>(q_pos), static_cast<const int*>(q_len),
      static_cast<T*>(out), static_cast<float*>(lse), n_slots, n_t, nq,
      nkv, window, split_pages(page) * page, n_splits, n_pages * page);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of fp32 workspace that paged_attention_launch needs for these
// shapes (0 where it launches nothing). It and the split grid grow with
// n_pages, the table's width: a caller passes only the columns that hold
// its rows' keys, not a table as wide as the pool.
extern "C" long long paged_attention_workspace(int n_slots, int n_t, int nq,
                                               int nkv, int head_dim,
                                               int n_pages, int page) {
  if (n_slots <= 0 || n_t <= 0 || nkv <= 0 || page <= 0) return 0;
  return (long long)n_slots * nkv * n_splits_of(n_pages, page) * n_t *
         (nq / nkv) * (head_dim + 2);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). head_dim
// 64 or 128; page <= 32; the pools' base 16-byte aligned. lse: null, or
// (R, T, nq) fp32 for each row's log-sum-exp (out's bits are the same
// either way). work: the fp32 workspace of paged_attention_workspace's
// size. Returns cudaGetLastError().
extern "C" int paged_attention_launch(
    const void* q, long long q_sr, long long q_st, long long q_sh,
    const void* kpool, const void* vpool, const void* table,
    const void* q_pos, const void* q_len, void* out, void* lse, void* work,
    int n_slots, int n_t, int nq, int nkv, int head_dim, int n_pages,
    int page, int n_phys, int window, float scale, int dtype, void* stream) {
  if (n_slots <= 0 || n_t <= 0) return 0;
  if (page <= 0 || page > kMaxPage || nkv <= 0 || nq % nkv || n_pages <= 0 ||
      (reinterpret_cast<uintptr_t>(kpool) | reinterpret_cast<uintptr_t>(
          vpool)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_ARGS q, q_sr, q_st, q_sh, kpool, vpool, table, q_pos, q_len, out, \
                lse, work, n_slots, n_t, nq, nkv, n_pages, page, n_phys,     \
                window, scale, s
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(K5_ARGS);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(K5_ARGS);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(K5_ARGS);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(K5_ARGS);
#undef K5_ARGS
  return (int)cudaErrorInvalidValue;
}
