// K7, MLA's absorbed decode attention over the latent cache, for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces no TPU kernel: the reference computes this step as jnp einsums
// outside any Pallas kernel (src/repro/layers/attention.py, mla_apply's
// "decode" branch). For each batch row b and head h, with idx = q_pos[b]:
//     s_j = scale * (q_eff[b,h] . ckv[b,j] + q_rope[b,h] . k_rope[b,j])
//     p   = softmax_j(s), j <= idx
//     ctx[b,h] = sum_j p_j ckv[b,j]
// where q_eff = q_nope W_uk is the query absorbed into the latent (the
// caller's product on K1's batched entry), and ctx's product with W_uv is
// the caller's too. The latent is R = 512 wide and the rotary key Dr = 64,
// both compile-time widths; the cache is float32 or bf16 (bf16 widens to
// fp32); the queries and ctx are float32, as the reference's einsums are.
//
// What bounds it: at V2-Lite's 16 heads, memory. Each cache row (576
// values) is read once for every 16 heads and each head does about 2,176
// operations a row (a 576-wide dot product and a 512-wide p v): 16 heads
// are ~35K operations against 2,304 bytes in fp32, below the ridge of the
// card's fp32 CUDA cores (67 TFLOP/s over 3.35 TB/s, ~20 per byte is 46K
// a row). At V3's 128 heads the operations bind (~279K a row). Both run
// on the CUDA cores here; tensor cores (wgmma, bf16) are later work.
//
// Design: a split walk and combine, as K5's (csrc/paged_attention.cu).
//  * The keys are cut into splits of kSplitKeys = 64, fixed by the key
//    position alone, never by the grid, the batch or idx.
//  * mla_split_kernel: one block of 8 warps per (b, tile of 16 heads,
//    split). The block stages the split's cache rows in two tiles of 32
//    rows, both in flight at once (cp.async, two stages of shared memory:
//    74 KB each in fp32, so the kernel opts in above 48 KB); a row is read
//    from device memory once for all 16 heads, and its first R values
//    serve as the value row too: V is the first R columns of K, the single
//    read that MLA's latent is for. Scores: warp w takes dims [72 w, 72 w
//    + 72) of the 576 for key `lane`, all 16 heads (the queries broadcast
//    from shared memory), and the 8 warps' partials are summed in warp
//    order. Warp w then keeps heads 2w and 2w + 1's online softmax (m, l)
//    in registers; each thread keeps 2 of the 512 context columns for all
//    16 heads (32 registers) and adds p v over the tile's keys in key
//    order. The split's (m, l, acc) go to an fp32 workspace. A block whose
//    split lies past idx returns at once; keys past idx are not loaded
//    (zeros in shared memory) and take p = 0 exactly.
//  * mla_combine_kernel: one block per (b, h) merges its splits in
//    ascending order up to the one holding idx, and divides by l. A row
//    with no key (idx < 0) writes 0.
// No atomics anywhere: repeated calls give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kR = 512;                  // the latent's width (kv_lora)
constexpr int kDr = 64;                  // the rotary key's width
constexpr int kRow = kR + kDr;           // a cache row as the scores read it
constexpr int kHeads = 16;               // heads a block
constexpr int kTile = 32;                // key rows a stage: a lane a key
constexpr int kTilesPerSplit = 2;
constexpr int kSplitKeys = kTile * kTilesPerSplit;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = kRow / kWarps;    // dims of the scores a warp
constexpr int kCols = kR / kThreads;     // context columns a thread
constexpr int kCombineThreads = kR / 4;  // 4 columns a thread
constexpr float kNegInf = -1e30f;        // NEG_INF of the JAX package

static_assert(kSlice % 8 == 0, "a warp's slice is whole 8-value groups");
static_assert(kHeads == 2 * kWarps, "a warp keeps two heads' softmax");
static_assert(kTile == 32 && kTile % 4 == 0, "a lane a key");

// a staged row's stride in elements: 16 bytes of padding, so that the 8
// lanes of a 16-byte load's phase read 8 rows on distinct banks
template <typename T>
constexpr int kStride = kRow + 16 / (int)sizeof(T);

// the floats of shared memory before the staged rows: the queries
// [kHeads][kRow], the warps' partial scores [kWarps][kHeads][kTile] and p
// [kHeads][kTile]
constexpr int kSmemFloats = kHeads * kRow + kWarps * kHeads * kTile +
                            kHeads * kTile;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * kSmemFloats +
         sizeof(T) * 2 * kTile * kStride<T>;
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

// 8 consecutive values of a staged row as floats (p 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // value 2i is word i's low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the kCols = 2 values of a staged row at p (8 or 4 bytes aligned)
__device__ __forceinline__ void load2(const float* p, float (&v)[kCols]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p,
                                      float (&v)[kCols]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// q_eff (B, H, kR) and q_rope (B, H, kDr) fp32 through (batch, head)
// strides; ckv (B, S, kR) and krope (B, S, kDr) through (batch, row)
// strides, unit stride along the row, rows 16-byte aligned. q_pos (B,)
// int32. part: acc (n_rows, kR) then (m, l) (n_rows, 2), n_rows = B * H *
// n_splits, row (b * H + h) * n_splits + split.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_split_kernel(const float* __restrict__ q_eff, int64_t q_sb, int64_t q_sh,
                 const float* __restrict__ q_rope, int64_t r_sb, int64_t r_sh,
                 const T* __restrict__ ckv, int64_t c_sb, int64_t c_ss,
                 const T* __restrict__ krope, int64_t k_sb, int64_t k_ss,
                 const int* __restrict__ q_pos, float* __restrict__ part,
                 int n_heads, int S, int n_splits, float scale) {
  constexpr int kSt = kStride<T>;
  constexpr int kChunk = 16 / (int)sizeof(T);   // values a 16-byte copy
  constexpr int kRowChunks = kRow / kChunk;
  extern __shared__ float4 smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* part_s = q_s + kHeads * kRow;
  float* p_s = part_s + kWarps * kHeads * kTile;
  T* kv_s = reinterpret_cast<T*>(p_s + kHeads * kTile);
  __shared__ float alpha_s[kHeads];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int split = blockIdx.z;
  const int n_here = min(kHeads, n_heads - h0);
  const int hi = min(q_pos[b], S - 1);   // the last key the row sees
  const int key0 = split * kSplitKeys;
  if (key0 > hi) return;                 // uniform: the split is past idx
  const int n_tiles = min(kTilesPerSplit, (hi - key0) / kTile + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // tile t's rows into stage t % 2: the latent then the rotary key; rows
  // past idx are zeros and never read from the cache
  auto load_tile = [&](int t) {
    T* dst = kv_s + (t % 2) * kTile * kSt;
    for (int c = threadIdx.x; c < kTile * kRowChunks; c += kThreads) {
      const int j = c / kRowChunks, e = (c % kRowChunks) * kChunk;
      const int key = key0 + t * kTile + j;
      const bool ok = key <= hi;
      const int64_t row = ok ? key : 0;
      const T* src = e < kR ? ckv + b * c_sb + row * c_ss + e
                            : krope + b * k_sb + row * k_ss + (e - kR);
      cp_async16(dst + j * kSt + e, src, ok);
    }
    cp_async_commit();
  };
  load_tile(0);
  if (n_tiles > 1) load_tile(1);
  for (int e = threadIdx.x; e < kHeads * kRow; e += kThreads) {
    const int i = e / kRow, d = e % kRow;
    float v = 0.f;
    if (i < n_here) {
      v = d < kR ? q_eff[b * q_sb + (h0 + i) * q_sh + d]
                 : q_rope[b * r_sb + (h0 + i) * r_sh + (d - kR)];
    }
    q_s[e] = v;
  }

  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[kHeads][kCols];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[h][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = kv_s + (t % 2) * kTile * kSt;

    // this warp's slice of every head's score for key `lane`
    {
      float sc[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) sc[h] = 0.f;
      const T* row = tile + lane * kSt + warp * kSlice;
      const float* qw = q_s + warp * kSlice;
#pragma unroll 1
      for (int d = 0; d < kSlice; d += 8) {
        float k8[8];
        load8(row + d, k8);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(qw + h * kRow + d);
          const float4 c =
              *reinterpret_cast<const float4*>(qw + h * kRow + d + 4);
          float s = sc[h];
          s = fmaf(a.x, k8[0], s);
          s = fmaf(a.y, k8[1], s);
          s = fmaf(a.z, k8[2], s);
          s = fmaf(a.w, k8[3], s);
          s = fmaf(c.x, k8[4], s);
          s = fmaf(c.y, k8[5], s);
          s = fmaf(c.z, k8[6], s);
          s = fmaf(c.w, k8[7], s);
          sc[h] = s;
        }
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        part_s[(warp * kHeads + h) * kTile + lane] = sc[h];
    }
    __syncthreads();

    // heads 2w and 2w + 1: the key's score (the warps' partials in
    // order), then the tile's step of the online softmax
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hh = 2 * warp + u;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s += part_s[(w * kHeads + hh) * kTile + lane];
      const bool ok = key0 + t * kTile + lane <= hi;
      s = ok ? s * scale : kNegInf;
      const float m_new = fmaxf(m_run[u], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run[u] - m_new);
      l_run[u] = l_run[u] * alpha + warp_sum(p);
      m_run[u] = m_new;
      p_s[hh * kTile + lane] = p;
      if (lane == 0) alpha_s[hh] = alpha;
    }
    __syncthreads();

    // this thread's context columns: rescale, then p v in key order
    {
      const int c0 = threadIdx.x * kCols;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float a = alpha_s[h];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[h][c] *= a;
      }
#pragma unroll 1
      for (int j = 0; j < kTile; j += 4) {
        float v[4][kCols];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          load2(tile + (j + jj) * kSt + c0, v[jj]);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float4 p = *reinterpret_cast<const float4*>(
              p_s + h * kTile + j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float a = acc[h][c];
            a = fmaf(p.x, v[0][c], a);
            a = fmaf(p.y, v[1][c], a);
            a = fmaf(p.z, v[2][c], a);
            a = fmaf(p.w, v[3][c], a);
            acc[h][c] = a;
          }
        }
      }
    }
    if (t + 2 < n_tiles) {  // uniform: the stage is read no more
      __syncthreads();
      load_tile(t + 2);
    }
  }

  const int64_t n_rows = (int64_t)gridDim.x * n_heads * n_splits;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {  // unrolled: acc stays in registers
    if (h >= n_here) break;
    const int64_t r = ((int64_t)b * n_heads + h0 + h) * n_splits + split;
    float* dst = part + r * kR + threadIdx.x * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = acc[h][c];
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hh = 2 * warp + u;
      if (hh >= n_here) continue;
      const int64_t r = ((int64_t)b * n_heads + h0 + hh) * n_splits + split;
      part[n_rows * kR + r * 2] = m_run[u];
      part[n_rows * kR + r * 2 + 1] = l_run[u];
    }
  }
}

// out (B, H, kR) fp32 contiguous: one block per (b, h)
__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* __restrict__ part,
                   const int* __restrict__ q_pos, float* __restrict__ out,
                   int n_heads, int S, int n_splits) {
  const int b = blockIdx.x / n_heads;
  const int hi = min(q_pos[b], S - 1);
  const int s_hi = hi < 0 ? -1 : hi / kSplitKeys;
  const int64_t n_rows = (int64_t)gridDim.x * n_splits;
  const int64_t row = (int64_t)blockIdx.x * n_splits;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float m = kNegInf, l = 0.f;
  for (int s = 0; s <= s_hi; ++s) {
    const float ms = part[n_rows * kR + (row + s) * 2];
    const float ls = part[n_rows * kR + (row + s) * 2 + 1];
    const float m_new = fmaxf(m, ms);
    const float a = expf(m - m_new), c = expf(ms - m_new);
    l = a * l + c * ls;
    const float4 v = *reinterpret_cast<const float4*>(
        part + (row + s) * kR + threadIdx.x * 4);
    acc[0] = a * acc[0] + c * v.x;
    acc[1] = a * acc[1] + c * v.y;
    acc[2] = a * acc[2] + c * v.z;
    acc[3] = a * acc[3] + c * v.w;
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(out + (int64_t)blockIdx.x * kR +
                             threadIdx.x * 4) =
      make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
}

int n_splits_of(int S) { return (S + kSplitKeys - 1) / kSplitKeys; }

template <typename T>
int launch(const float* q_eff, long long q_sb, long long q_sh,
           const float* q_rope, long long r_sb, long long r_sh,
           const void* ckv, long long c_sb, long long c_ss,
           const void* krope, long long k_sb, long long k_ss,
           const int* q_pos, float* out, float* work, int B, int H, int S,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T>();
  static bool opted_in = false;  // above 48 KB of shared memory
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int n_splits = n_splits_of(S);
  const dim3 grid(B, (H + kHeads - 1) / kHeads, n_splits);
  mla_split_kernel<T><<<grid, kThreads, smem, s>>>(
      q_eff, q_sb, q_sh, q_rope, r_sb, r_sh, static_cast<const T*>(ckv),
      c_sb, c_ss, static_cast<const T*>(krope), k_sb, k_ss, q_pos, work, H,
      S, n_splits, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_combine_kernel<<<B * H, kCombineThreads, 0, s>>>(work, q_pos, out, H,
                                                       S, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of fp32 workspace that mla_decode_launch needs for these shapes.
extern "C" long long mla_decode_workspace(int B, int H, int S) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  return (long long)B * H * n_splits_of(S) * (kR + 2);
}

// dtype: the cache's, 0 = float32, 1 = bfloat16; q_eff, q_rope and out are
// float32. R must be 512 and Dr 64; the cache's rows 16-byte aligned. out
// (B, H, 512) contiguous. work: mla_decode_workspace's floats. Returns
// cudaGetLastError().
extern "C" int mla_decode_launch(
    const float* q_eff, long long q_sb, long long q_sh, const float* q_rope,
    long long r_sb, long long r_sh, const void* ckv, long long c_sb,
    long long c_ss, const void* krope, long long k_sb, long long k_ss,
    const int* q_pos, float* out, float* work, int B, int H, int S, int R,
    int Dr, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (R != kR || Dr != kDr || S <= 0 ||
      (reinterpret_cast<uintptr_t>(ckv) | reinterpret_cast<uintptr_t>(
          krope)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K7_ARGS q_eff, q_sb, q_sh, q_rope, r_sb, r_sh, ckv, c_sb, c_ss, \
                krope, k_sb, k_ss, q_pos, out, work, B, H, S, scale, s
  if (dtype == 0) return launch<float>(K7_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(K7_ARGS);
#undef K7_ARGS
  return (int)cudaErrorInvalidValue;
}
