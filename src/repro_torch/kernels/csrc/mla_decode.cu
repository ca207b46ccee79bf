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
// What bounds it. A (key, head) pair is 2,176 operations (a 576-wide dot
// product and a 512-wide p v). At V2-Lite's 16 heads (B 4, 520 keys) a
// call moves 4.8 MB in fp32: bytes bind (1.51 us), but each block's work
// is a short chain (its rows and queries in, ~400 MMAs, its partial
// context out), so the time is that chain and the combine's. At V3's 128
// heads it is 579 MFLOP: 8.6 us on the fp32 CUDA cores, 3.5 us in split
// TF32 at wgmma's 495 TFLOP/s. mma.sync m16n8k8 peaks at 0.58 MMAs an SM
// a clock here (311 TFLOP/s TF32, tools/k7_turns.py --mma-rate), 5.6 us
// for these 848,640 MMAs; this kernel issues them at 0.12 over the call
// (27.4 us), between phases that leave the tensor pipe idle (a block-wide
// softmax, barriers). The SASS of its tile loop is the fragments' loads,
// the splits and the MMAs, nothing more; a second block on the SM, or a
// block of 16 warps on two head tiles, runs the same phases in lockstep
// and hides none of them (both measured, below). The next step is wgmma
// (B from shared memory; V then needs a K-major copy), later work.
//
// Design:
//  * the products run on the tensor cores: mma.sync m16n8k8 in TF32 with
//    fp32 sums, a block's 16 heads the M dimension (MLA's queries all read
//    one latent). fp32 accuracy comes from the 3xTF32 split (CUTLASS's
//    "fast fp32"): x = big + small, big x rounded to TF32 (as
//    cvt.rna.tf32.f32 does, in two integer operations) and small the exact
//    rest, and a product is small.big + big.small + big.big. A bf16 cache
//    is exact in TF32: its small part is zero and a product takes 2 MMAs;
//  * a block is (b, 16 heads, split) with 8 warps. Scores: warp w keeps
//    its 72 of the 576 query dims in registers (the A fragments) and takes
//    both 8-key column tiles of a 16-key tile, in three chains of MMAs (one
//    a product of the split); the warps' partial scores are summed in warp
//    order through shared memory. Warp w runs heads 2w and 2w + 1's online
//    softmax (16 lanes a head), then p v: it owns context columns [64 w,
//    64 w + 64), 8 column tiles accumulated in registers across the
//    split, their MMAs interleaved. The B fragments come from the staged
//    rows, whose first 512 values are the value row: V is the first R
//    columns of K, read from device memory once per (row, head tile). Row
//    strides of 580 floats / 584 bf16 keep every fragment load free of
//    bank conflicts (fp32 p v takes a column tile's 8 columns as two runs
//    of 4, 16 apart);
//  * splits are fixed by the key position: one 16-key tile at up to 16
//    heads, so that V2-Lite's 4 x 33 blocks fill 132 SMs, and 8 tiles (128
//    keys) above, whose next tile is copied (cp.async) while one is used;
//    a split costs its heads' queries and a partial context of 2 KB a
//    head, which longer splits cut. The queries arrive by cp.async with
//    the first tile, issued while q_pos is read (16-byte copies where their
//    rows are 16-byte aligned, else 4-byte), and take the second stage's
//    room (fp32), so that two blocks fit an SM (88 KB, 128 registers); each
//    thread copies the same 16 bytes of its rows every tile. The partial
//    context leaves through shared memory as whole rows. A block whose
//    split lies past idx returns at once; keys past idx are never loaded
//    (zeros in shared memory) and take p = 0 exactly;
//  * mla_combine_kernel merges each (b, h)'s splits in ascending order up
//    to idx's (the maximum first, then the weighted sums, the 4 threads of
//    a column on every 4th split, added in thread order), and divides by
//    l; a row with no key (idx < 0) writes 0. It is launched with
//    programmatic dependent launch: its blocks are placed while the split
//    kernel runs and wait (griddepcontrol.wait) for its results.
// No atomics anywhere: repeated calls give the same bits.
//
// Variants timed in turns against this one (tools/k7_turns.py, NVIDIA H100
// 80GB HBM3 at 700 W, float32 cache; us at V2-Lite / V3 / g_y = 2's 8
// heads, this design first): 9.08-9.26 / 27.44-27.74 / 8.09 us, PR 33's
// 28.98-29.11 / 71.77-72.28 / 24.82-24.85. The products on the CUDA cores
// (PR 33's arithmetic in these blocks: partial scores by half-warps, p v 2
// columns a thread for 16 heads): 10.51-10.62 / 42.16-42.62 / 9.41.
// cvt.rna.tf32.f32 for the rounding: 9.49-9.63 / 32.14-32.43 / 8.38-8.39.
// 64-key splits above 16 heads: 9.23-9.35 / 27.46-27.56 / 8.11 (bf16 V3
// 22.48-22.59 against 20.74-21.03). One block an SM, no register cap:
// 9.34-9.38 / 29.29-29.71 / 8.09-8.14. 32-key tiles above 16 heads (one
// block an SM, the queries split once): 9.21-9.27 / 29.57-29.64 / 8.11-
// 8.15. Two head tiles a block of 16 warps above 16 heads: V3 30.28-30.56
// with 64-key splits, 36.14-36.27 with 128, against 27.32-27.45. The
// design's steps as they were timed: the first form (64-key splits above
// 16 heads, the queries loaded as scattered 4-byte fragments, the partial
// context stored from the fragments, a combine walking the splits one by
// one, spills at the register cap) 20.3-20.5 / 61.3-61.6 / 17.9-18.6; a
// combine over the splits at once, whole query and context rows through
// shared memory, three score chains, 128-key splits, no register cap
// 13.3 / 37.7-37.9 / 12.4;
// cp.async queries, the integer rounding, 4 combine threads a column
// 10.0 / 31.4-31.8 / 8.8-8.9; two blocks an SM 9.6-9.8 / 30.5-31.0 /
// 8.6; each thread's fixed copy offsets 9.3 / 27.6-27.8 / 8.1. Splits of
// 32 keys at 16 heads (66 blocks) ran 22.6 against the first form's 20.5.
// At V3, without the MMAs the call still took 21.8 us of 30.3, and without
// any global read 29.2 of 30.1: the phases bind, not the bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kR = 512;                  // the latent's width (kv_lora)
constexpr int kDr = 64;                  // the rotary key's width
constexpr int kRow = kR + kDr;           // a cache row as the scores read it
constexpr int kHeads = 16;               // heads a block: one MMA row tile
constexpr int kTile = 16;                // key rows a stage
constexpr int kNarrowTiles = 1;          // tiles a split at up to 16 heads
constexpr int kWideTiles = 8;            // ... and above
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = kRow / kWarps;    // score dims a warp (72)
constexpr int kSteps = kSlice / 8;       // its MMA k-steps (9)
constexpr int kWarpCols = kR / kWarps;   // context columns a warp (64)
constexpr int kPartStride = kTile + 8;   // a head's row of partial scores
constexpr int kPStride = kTile + 4;      // a head's row of p
constexpr int kQStride = kRow + 4;       // a head's query row in shared memory
constexpr int kCtxStride = kR + 4;       // ... and its partial context
constexpr int kCombineCols = 128;        // context columns a combine block
constexpr int kCombineGroups = 4;        // its threads on a column
constexpr int kCombineThreads = kCombineCols / 4 * kCombineGroups;
constexpr float kNegInf = -1e30f;        // NEG_INF of the JAX package

static_assert(kSlice % 8 == 0, "whole MMA k-steps");
static_assert(kHeads == 2 * kWarps, "a warp keeps two heads' softmax");
static_assert(kTile == 16, "two 8-key column tiles; 16 lanes a head");
static_assert(kWarpCols == 64, "8 column tiles of 8 a warp");
static_assert(kCtxStride <= kQStride, "the context fits the queries' room");

// a staged row's stride in elements: 16 bytes of padding, 4 banks, so that
// the 8 rows of an MMA fragment (or of a 16-byte load's phase) sit on
// distinct banks
template <typename T>
constexpr int kStride = kRow + 16 / (int)sizeof(T);

// a block's shared memory: the warps' partial scores, p, one stage of
// tiles (a split of one tile) or two, and the queries, which take the
// second stage's room where it is as large (fp32 tiles; the warps keep the
// queries in registers from the first tile on), so that two blocks fit an
// SM
template <int kTiles>
constexpr int kStages = kTiles > 1 ? 2 : 1;
template <typename T, int kTiles>
constexpr bool kQInStage = kTiles > 1 && sizeof(T) == 4;
static_assert(kTile * kStride<float> == kHeads * kQStride, "a stage holds Q");

template <typename T, int kTiles>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kWarps * kHeads * kPartStride + kHeads * kPStride +
                          (kQInStage<T, kTiles> ? 0 : kHeads * kQStride)) +
         sizeof(T) * kStages<kTiles> * kTile * kStride<T>;
}

// ---- Hopper instructions, with the CPU emulator's stand-ins (CUDA_EMU,
// tests/cuda_emu/) for a build without a card ----

// d += a b, one m16n8k8 product in TF32 with fp32 sums. a: rows g and g + 8,
// k t and t + 4 (g = lane / 4, t = lane % 4); b: k t and t + 4, column g;
// d: rows g and g + 8, columns 2t and 2t + 1
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(CUDA_EMU)
  emu::mma_m16n8k8_tf32(d, a, b);
#endif
}

// x (finite) rounded to TF32, to nearest with ties away from zero: the
// rounding of cvt.rna.tf32.f32, in two integer operations at the full rate
// (the conversion instruction ran slower, see above)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// let the dependent grid (the combine) be scheduled / wait for the grid
// this one depends on to finish and its writes to be visible
__device__ __forceinline__ void launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
#endif
}
__device__ __forceinline__ void wait_dependency() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#elif defined(CUDA_EMU)
  emu::griddepcontrol_wait();
#endif
}

// x = big + small: big rounded to TF32, small the exact rest, whose bits
// below TF32's the MMA drops (CUTLASS's "fast fp32" split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float warp_max16(float v) {  // within 16 lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(v) << 16);
}

// the context column of warp `warp`'s column tile n (0..7) and MMA column
// m (0..7). fp32 rows sit 4 banks apart, so a tile's 8 columns are two runs
// of 4, 16 apart, for the 4 keys x 8 columns of a B fragment to fill 32
// banks; bf16 packs two columns a bank, and 8 in a row do it
template <typename T>
__device__ __forceinline__ int col_of(int warp, int n, int m) {
  if constexpr (sizeof(T) == 4) {
    return warp * kWarpCols + 4 * (n & 3) + 32 * (n >> 2) + (m & 3) +
           16 * (m >> 2);
  } else {
    return warp * kWarpCols + 8 * n + m;
  }
}

// q_eff (B, H, kR) and q_rope (B, H, kDr) fp32 through (batch, head)
// strides; ckv (B, S, kR) and krope (B, S, kDr) through (batch, row)
// strides, unit stride along the row, rows 16-byte aligned. q_pos (B,)
// int32. part: acc (n_rows, kR) then (m, l) (n_rows, 2), n_rows = B * H *
// n_splits, row (b * H + h) * n_splits + split.
template <typename T, int kTiles>
__global__ void __launch_bounds__(kThreads, 2)
mla_split_kernel(const float* __restrict__ q_eff, int64_t q_sb, int64_t q_sh,
                 const float* __restrict__ q_rope, int64_t r_sb, int64_t r_sh,
                 const T* __restrict__ ckv, int64_t c_sb, int64_t c_ss,
                 const T* __restrict__ krope, int64_t k_sb, int64_t k_ss,
                 const int* __restrict__ q_pos, float* __restrict__ part,
                 int n_heads, int S, int n_splits, float scale, bool q16) {
  constexpr int kSt = kStride<T>;
  constexpr int kSt_ = kStages<kTiles>;
  constexpr int kChunk = 16 / (int)sizeof(T);   // values a 16-byte copy
  constexpr int kLatChunks = kR / kChunk, kRopeChunks = kDr / kChunk;
  constexpr int kLatRows = kThreads / kLatChunks;  // latent rows a round
  static_assert(kTile % kLatRows == 0 && kThreads / kRopeChunks >= kTile,
                "whole rounds of latent copies; one of rotary keys");
  constexpr bool kExact = sizeof(T) == 2;       // bf16: exact in TF32
  launch_dependents();
  extern __shared__ float4 smem[];
  float* part_s = reinterpret_cast<float*>(smem);
  float* p_s = part_s + kWarps * kHeads * kPartStride;
  constexpr bool kQIn = kQInStage<T, kTiles>;
  T* kv_s = reinterpret_cast<T*>(p_s + kHeads * kPStride);
  // the queries, then the context
  float* q_s = reinterpret_cast<float*>(kv_s + (kQIn ? 1 : kSt_) * kTile * kSt);
  __shared__ float alpha_s[kHeads];

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int split = blockIdx.z;
  const int n_here = min(kHeads, n_heads - h0);

  const int pos = q_pos[b];
  // the 16 query rows (rows past the block's heads zero), in the first
  // tile's group of copies and issued while q_pos is read: 16-byte copies
  // where every row is 16-byte aligned, else 4-byte
  if (q16) {
    for (int c = threadIdx.x; c < kHeads * kRow / 4; c += kThreads) {
      const int i = c / (kRow / 4), d = c % (kRow / 4) * 4;
      const bool ok = i < n_here;
      const float* src =
          !ok      ? q_eff
          : d < kR ? q_eff + b * q_sb + (h0 + i) * q_sh + d
                   : q_rope + b * r_sb + (h0 + i) * r_sh + d - kR;
      cp_async16(q_s + i * kQStride + d, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kHeads * kRow; e += kThreads) {
      const int i = e / kRow, d = e % kRow;
      const bool ok = i < n_here;
      const float* src =
          !ok      ? q_eff
          : d < kR ? q_eff + b * q_sb + (h0 + i) * q_sh + d
                   : q_rope + b * r_sb + (h0 + i) * r_sh + d - kR;
      cp_async4(q_s + i * kQStride + d, src, ok);
    }
  }
  const int hi = min(pos, S - 1);        // the last key the row sees
  const int key0 = split * kTiles * kTile;
  if (key0 > hi) {                       // uniform: the split is past idx
    cp_async_commit();                   // (its queries' copies land first)
    cp_async_wait<0>();
    return;
  }
  const int n_tiles = min(kTiles, (hi - key0) / kTile + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA fragment coordinates

  // tile i's rows into stage i % kStages: the latent then the rotary key;
  // rows past idx are zeros and never read from the cache. A thread copies
  // the same 16 bytes of its rows every tile
  const int lat_j = threadIdx.x / kLatChunks;
  const int lat_e = threadIdx.x % kLatChunks * kChunk;
  const int rope_j = threadIdx.x / kRopeChunks;
  const int rope_e = threadIdx.x % kRopeChunks * kChunk;
  auto load_tile = [&](int i) {
    T* dst = kv_s + (i % kSt_) * kTile * kSt;
    const int key_i = key0 + i * kTile;
#pragma unroll
    for (int r = 0; r < kTile / kLatRows; ++r) {
      const int j = lat_j + r * kLatRows, key = key_i + j;
      const bool ok = key <= hi;
      cp_async16(dst + j * kSt + lat_e,
                 ckv + b * c_sb + (int64_t)(ok ? key : 0) * c_ss + lat_e, ok);
    }
    if (rope_j < kTile) {
      const int key = key_i + rope_j;
      const bool ok = key <= hi;
      cp_async16(dst + rope_j * kSt + kR + rope_e,
                 krope + b * k_sb + (int64_t)(ok ? key : 0) * k_ss + rope_e,
                 ok);
    }
    cp_async_commit();
  };
  load_tile(0);
  if (!kQIn && kSt_ > 1 && n_tiles > 1) load_tile(1);

  // this warp's A fragments of the queries, kept in registers
  float qf[kSteps][4];

  // softmax: lanes 16u..16u + 15 keep head 2 warp + u, one key a lane
  const int key = lane & 15, hh = 2 * warp + (lane >> 4);
  float m_run = kNegInf, l_run = 0.f;
  // the context: 8 column tiles x the MMA's 4 values
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (kSt_ > 1 && i + 1 < n_tiles && !(kQIn && i == 0)) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* tile = kv_s + (i % kSt_) * kTile * kSt;

    // this warp's slice of the 16 x 16 scores
    {
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const float* q = q_s + g * kQStride + warp * kSlice + 8 * j + t;
          qf[j][0] = q[0];
          qf[j][1] = q[8 * kQStride];
          qf[j][2] = q[4];
          qf[j][3] = q[8 * kQStride + 4];
        }
        if constexpr (kQIn) {  // the queries read, tile 1 takes their room
          __syncthreads();
          if (n_tiles > 1) load_tile(1);
        }
      }
      // three chains a column tile, one for each of the split's products
      float sc[2][3][4] = {};
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        uint32_t ab[4], as[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(qf[j][r], ab[r], as[r]);
        const int d = warp * kSlice + 8 * j + t;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const T* row = tile + (8 * n + g) * kSt + d;
          uint32_t bb[2], bs[2];
          if constexpr (kExact) {
            bb[0] = __float_as_uint(to_f(row[0]));
            bb[1] = __float_as_uint(to_f(row[4]));
          } else {
            split_tf32(to_f(row[0]), bb[0], bs[0]);
            split_tf32(to_f(row[4]), bb[1], bs[1]);
          }
          mma_tf32(sc[n][0], as, bb);
          if constexpr (!kExact) mma_tf32(sc[n][1], ab, bs);
          mma_tf32(sc[n][2], ab, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r] = (sc[n][0][r] + sc[n][1][r]) + sc[n][2][r];
        float* dst = part_s + (warp * kHeads + g) * kPartStride + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(dst + 8 * kPartStride) =
            make_float2(v[2], v[3]);
      }
    }
    __syncthreads();

    // head hh: the key's score (the warps' partials in order), then the
    // tile's step of the online softmax
    {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s += part_s[(w * kHeads + hh) * kPartStride + key];
      const bool ok = key0 + i * kTile + key <= hi;
      s = ok ? s * scale : kNegInf;
      const float m_new = fmaxf(m_run, warp_max16(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + warp_sum16(p);
      m_run = m_new;
      p_s[hh * kPStride + key] = p;
      if (key == 0) alpha_s[hh] = alpha;
    }
    __syncthreads();

    // the context: rescale, then p v over the tile's keys
    {
      const float a_lo = alpha_s[g], a_hi = alpha_s[g + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= a_lo;
        acc[n][1] *= a_lo;
        acc[n][2] *= a_hi;
        acc[n][3] *= a_hi;
      }
#pragma unroll
      for (int ks = 0; ks < kTile / 8; ++ks) {
        uint32_t ab[4], as[4];
        const float* pr = p_s + g * kPStride + 8 * ks + t;
        split_tf32(pr[0], ab[0], as[0]);
        split_tf32(pr[8 * kPStride], ab[1], as[1]);
        split_tf32(pr[4], ab[2], as[2]);
        split_tf32(pr[8 * kPStride + 4], ab[3], as[3]);
        const T* v0 = tile + (8 * ks + t) * kSt;
        // 4 column tiles at a time, their MMAs interleaved so that no
        // MMA waits on the one before it (each tile's own order kept)
#pragma unroll
        for (int n0 = 0; n0 < 8; n0 += 4) {
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int c = col_of<T>(warp, n0 + n, g);
            if constexpr (kExact) {
              bb[n][0] = __float_as_uint(to_f(v0[c]));
              bb[n][1] = __float_as_uint(to_f(v0[4 * kSt + c]));
            } else {
              split_tf32(to_f(v0[c]), bb[n][0], bs[n][0]);
              split_tf32(to_f(v0[4 * kSt + c]), bb[n][1], bs[n][1]);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], as, bb[n]);
          if constexpr (!kExact) {
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ab, bs[n]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_tf32(acc[n0 + n], ab, bb[n]);
        }
      }
    }
    if (i + kSt_ < n_tiles) {  // uniform: the stage is read no more
      __syncthreads();
      load_tile(i + kSt_);
    }
  }

  const int64_t n_rows = (int64_t)gridDim.x * n_heads * n_splits;
  auto row_of = [&](int h) {
    return ((int64_t)b * n_heads + h0 + h) * n_splits + split;
  };
  {
    // through shared memory (the queries' room), for whole-row stores
    float* ctx_s = q_s;
    __syncthreads();  // the last tile is read
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* dst = ctx_s + g * kCtxStride + col_of<T>(warp, n, 2 * t);
      *reinterpret_cast<float2*>(dst) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(dst + 8 * kCtxStride) =
          make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kHeads * kR / 4 / kThreads; ++k) {
      const int e = threadIdx.x + k * kThreads, h = e / (kR / 4),
                c = e % (kR / 4) * 4;
      if (h < n_here)
        *reinterpret_cast<float4*>(part + row_of(h) * kR + c) =
            *reinterpret_cast<const float4*>(ctx_s + h * kCtxStride + c);
    }
  }
  if (key == 0 && hh < n_here) {
    part[n_rows * kR + row_of(hh) * 2] = m_run;
    part[n_rows * kR + row_of(hh) * 2 + 1] = l_run;
  }
}

// out (B, H, kR) fp32 contiguous: a block per (b, h) and 128 columns,
// launched as the split kernel's dependent. The splits' weights
// exp(m_s - max m) go through shared memory a chunk at a time; the 4
// threads of a column take every 4th split each, so that their loads of
// the splits' partial contexts are independent and in flight together,
// and their sums are added in thread order: a fixed order, whatever the
// grid.
constexpr int kCombineChunk = 256;  // splits whose weights a pass holds

// part is not a restrict pointer, so that its reads stay after the wait:
// a read through const __restrict__ may be taken as invariant and moved
// ahead of it
__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* part, const int* __restrict__ q_pos,
                   float* __restrict__ out, int n_heads, int S, int n_splits,
                   int split_keys) {
  __shared__ float c_s[kCombineChunk], cl_s[kCombineChunk];
  __shared__ float max_s[kCombineThreads / 32];
  __shared__ float4 acc_s[kCombineGroups - 1][kCombineCols / 4];
  __shared__ float l_s[kCombineGroups - 1];
  const int c4 = threadIdx.x % (kCombineCols / 4);
  const int col = blockIdx.y * kCombineCols / 4 + c4;
  const int grp = threadIdx.x / (kCombineCols / 4);
  const int b = blockIdx.x / n_heads;
  const int hi = min(q_pos[b], S - 1);
  const int n_here = hi < 0 ? 0 : hi / split_keys + 1;  // splits to merge
  const int64_t n_rows = (int64_t)gridDim.x * n_splits;
  const int64_t row = (int64_t)blockIdx.x * n_splits;
  const float* ml = part + n_rows * kR + row * 2;
  const float* acc_in = part + row * kR + col * 4;
  wait_dependency();
  float m = kNegInf;
  for (int s = threadIdx.x; s < n_here; s += kCombineThreads)
    m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) max_s[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kCombineThreads / 32; ++w) m = fmaxf(m, max_s[w]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int s0 = 0; s0 < n_here; s0 += kCombineChunk) {
    const int n = min(kCombineChunk, n_here - s0);
    __syncthreads();  // the chunk before is read
    for (int s = threadIdx.x; s < n; s += kCombineThreads) {
      const float c = expf(ml[2 * (s0 + s)] - m);
      c_s[s] = c;
      cl_s[s] = c * ml[2 * (s0 + s) + 1];
    }
    __syncthreads();
#pragma unroll 8
    for (int s = grp; s < n; s += kCombineGroups) {
      const float c = c_s[s];
      const float4 v =
          *reinterpret_cast<const float4*>(acc_in + (int64_t)(s0 + s) * kR);
      l += cl_s[s];
      acc.x += c * v.x;
      acc.y += c * v.y;
      acc.z += c * v.z;
      acc.w += c * v.w;
    }
  }
  if (grp > 0) {
    acc_s[grp - 1][c4] = acc;
    if (c4 == 0) l_s[grp - 1] = l;
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int q = 0; q < kCombineGroups - 1; ++q) {
    const float4 v = acc_s[q][c4];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    l += l_s[q];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  *reinterpret_cast<float4*>(out + (int64_t)blockIdx.x * kR + col * 4) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// 16-key tiles a split for n_heads heads (a block's 16 at most, or more)
int tiles_of(int n_heads) {
  return n_heads > kHeads ? kWideTiles : kNarrowTiles;
}

int n_splits_of(int S, int n_heads) {
  const int keys = tiles_of(n_heads) * kTile;
  return (S + keys - 1) / keys;
}

template <typename T, int kTiles>
int launch(const float* q_eff, long long q_sb, long long q_sh,
           const float* q_rope, long long r_sb, long long r_sh,
           const void* ckv, long long c_sb, long long c_ss,
           const void* krope, long long k_sb, long long k_ss,
           const int* q_pos, float* out, float* work, int B, int H, int S,
           float scale, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, kTiles>();
  auto kernel = mla_split_kernel<T, kTiles>;
  static bool opted_in = false;  // above 48 KB of shared memory
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int n_splits = n_splits_of(S, H);
  const bool q16 = ((reinterpret_cast<uintptr_t>(q_eff) |
                     reinterpret_cast<uintptr_t>(q_rope)) % 16 == 0) &&
                   (q_sb | q_sh | r_sb | r_sh) % 4 == 0;
  const dim3 grid(B, (H + kHeads - 1) / kHeads, n_splits);
  mla_split_kernel<T, kTiles><<<grid, kThreads, smem, s>>>(
      q_eff, q_sb, q_sh, q_rope, r_sb, r_sh, static_cast<const T*>(ckv),
      c_sb, c_ss, static_cast<const T*>(krope), k_sb, k_ss, q_pos, work, H,
      S, n_splits, scale, q16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, kR / kCombineCols);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mla_combine_kernel, (const float*)work,
                           q_pos, out, H, S, n_splits, kTiles * kTile);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const float* q_eff, long long q_sb, long long q_sh,
             const float* q_rope, long long r_sb, long long r_sh,
             const void* ckv, long long c_sb, long long c_ss,
             const void* krope, long long k_sb, long long k_ss,
             const int* q_pos, float* out, float* work, int B, int H, int S,
             float scale, cudaStream_t s) {
#define K7_ARGS q_eff, q_sb, q_sh, q_rope, r_sb, r_sh, ckv, c_sb, c_ss, \
                krope, k_sb, k_ss, q_pos, out, work, B, H, S, scale, s
  if (H > kHeads) return launch<T, kWideTiles>(K7_ARGS);
  return launch<T, kNarrowTiles>(K7_ARGS);
#undef K7_ARGS
}

}  // namespace

// Floats of fp32 workspace that mla_decode_launch needs for these shapes.
extern "C" long long mla_decode_workspace(int B, int H, int S) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  return (long long)B * H * n_splits_of(S, H) * (kR + 2);
}

// Keys a split for H heads (the splits are fixed by the key position).
extern "C" int mla_decode_split_keys(int H) { return tiles_of(H) * kTile; }

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
  if (dtype == 0) return dispatch<float>(K7_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16>(K7_ARGS);
#undef K7_ARGS
  return (int)cudaErrorInvalidValue;
}
