// Tiles and device helpers shared by the attention kernels K2
// (flash_attention.cu) and K4 (partial_attention.cu). Two designs live
// here. The register-tiled one (K2's forward and backward, K4's forward):
// 128 threads as 8 x 16, each owning a few rows x a few columns of a tile
// product in registers, fp32 tiles in shared memory read as float4, K's
// 16-byte chunks XOR-swizzled by row where 16 rows are read at once, and
// tile loads split in an issue half and a commit half so that they overlap
// other work (cp.async for float32, a register stage for bfloat16); the
// forwards' walk over key tiles (`attend`). The first-port one (K4's
// backward): 256 threads as 16 x 16, square 64-row query and key tiles
// through padded shared memory, 4 rows and 4 score columns a thread.
// Everything sits in an anonymous namespace: each source that includes it
// gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // first-port tiles; row-wise passes
constexpr int BQ = 64;              // query rows per tile
constexpr int BKV = 64;             // keys per tile
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

// ---------------------------------------------------------------------- //
// the register-tiled kernels
// ---------------------------------------------------------------------- //

constexpr int kTileThreads = 128;  // 8 x 16: ty = tid / 16, tx = tid % 16

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
// the call; Ks and Vs are [BKV][HD] (K's chunks swizzled), Ps [8 FR][BKV].
// Thread (ty, tx) owns query rows ty + 8 i (i < FR): their scores against
// keys tx + 16 j (j < 4) of a tile, reading Q and K as float4 along
// head_dim, then their output columns 4 (tx + 16 c) .. + 3, reading P and
// V as float4. V of a tile streams in while Q K^T runs and the next K
// while the softmax and P V run. vis(r, j) says whether tile row r sees key
// j; a masked score gives p = 0 exactly, so a row that sees no key of a
// tile keeps its carry bit for bit (alpha = exp(0) = 1), and a tile whose
// every score is masked may be walked or skipped with the same bits.
template <typename T, int HD, int FR, typename Vis>
__device__ __forceinline__ void attend(const float* Qs, float* Ks, float* Vs,
                                       float* Ps, const T* kb, int64_t k_st,
                                       const T* vb, int64_t v_st, int n_s,
                                       int lo, int hi, bool vec, uint4* reg,
                                       float scale, const Vis& vis,
                                       float (&m)[FR], float (&l)[FR],
                                       float4 (&acc)[FR][HD / 64]) {
  constexpr int D4 = HD / 4;   // 16-byte chunks of a row
  constexpr int NC = HD / 64;  // output chunks of a thread
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
    tile_issue<T, HD, BKV, false>(Vs, vb, v_st, j0, n_s, vec, reg);
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
    tile_commit<T, HD, BKV, false>(Vs, vb, v_st, j0, n_s, vec, reg);
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
        ok[j] = vis(ty + 8 * i, j0 + tx + 16 * j);
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
      tile_commit<T, HD, BKV, true>(Ks, kb, k_st, j0 + BKV, n_s, vec, reg);
    cp_async_wait<0>();
    __syncthreads();  // the next K is in; Vs and Ps are free
  }
}

// shared memory (bytes) of a forward over query tiles of ROWS rows: the Q
// tile [ROWS][HD], K and V [BKV][HD] and P [ROWS][BKV], fp32
template <int HD, int ROWS>
constexpr size_t attend_smem() {
  return sizeof(float) * (ROWS * HD + 2 * BKV * HD + ROWS * BKV);
}

// ---------------------------------------------------------------------- //
// the first-port kernels (K4's backward)
// ---------------------------------------------------------------------- //

constexpr int RI = BQ / 16;         // rows per thread
constexpr int RJ = BKV / 16;        // score columns per thread
constexpr int PLD = BKV + 16;       // row stride of the score tiles
static_assert(BQ == BKV, "the backward's tile loops assume square tiles");

// rows [r0, r0 + rows) of a (n_rows, HD) slice with row stride `stride`
// into dst (row stride ld) as fp32; rows past n_rows read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int r0, int n_rows,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int gr = r0 + r;
    dst[r * ld + d] = gr < n_rows ? to_f(src[gr * stride + d]) : 0.f;
  }
}

// shared memory (bytes) of K4's backward kernels
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * BQ * (HD + 1) + 2 * BKV * PLD + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BQ * (HD + 1) + BQ * PLD);
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

}  // namespace
