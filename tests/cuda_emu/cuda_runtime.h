// A CPU stand-in for the part of the CUDA runtime that the port's kernel
// sources use, so that a test can compile a source with g++ and run its logic
// on the CPU (tests/test_torch_k1_emulated.py,
// tests/test_torch_attention_emulated.py, tests/test_torch_rmsnorm_emulated.py,
// tests/test_torch_scan_emulated.py, tests/test_torch_k7_emulated.py). Each
// CUDA thread is a std::thread, made once per launch; the blocks of a grid run
// one after another, so a __shared__ array is a function-local static;
// __syncthreads is a std::barrier over the block; a warp shuffle passes through
// a per-warp buffer between two barriers of its 32 threads. A launch `k<<<g, b,
// s, st>>>(args)` is rewritten by the test to `emu::launch(g, b, s, st, k,
// args)`, and `extern __shared__ T name[];` to a pointer into the launch's
// dynamic shared memory, emu::dyn_smem (s bytes, 16-byte aligned, fresh for
// each launch). Nothing here models timing or memory spaces; a source's
// asynchronous copies (cp.async) take their portable branch, outside `#ifdef
// __CUDA_ARCH__`, and copy at once. Where a source has no portable branch for
// an instruction (a tensor-core product, a wait on the grid it depends on), it
// calls the stand-in of namespace emu below under `#elif defined(CUDA_EMU)`; a
// launch through cudaLaunchKernelEx runs at once, its attributes (programmatic
// dependent launch) ignored, since grids run one after another here.
#pragma once
#define CUDA_EMU 1
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the device's rsqrtf is an approximation (2 ulp); this one rounds once
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

namespace emu {
inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barrier;
inline float warp_buffer[32][32];
inline char* dyn_smem = nullptr;

template <typename F, typename... A>
void launch(dim3 g, dim3 b, size_t smem, cudaStream_t, F kernel,
            A... args) {
  const unsigned n = b.x * b.y * b.z;
  if (n % 32 || n > 1024) abort();
  std::vector<float4> dyn((smem + 15) / 16 + 1);
  dyn_smem = reinterpret_cast<char*>(dyn.data());
  blockDim = b;
  gridDim = g;
  // the block's threads are made once and walk the grid's blocks in turn,
  // meeting at `done` between blocks (so the statics that stand for
  // __shared__ are never used by two blocks at once)
  std::barrier<> bar(n), done(n);
  block_barrier = &bar;
  warp_barrier.clear();
  for (unsigned w = 0; w < n / 32; ++w)
    warp_barrier.emplace_back(new std::barrier<>(32));
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([=, &done] {
      threadIdx = dim3(t);
      for (unsigned z = 0; z < g.z; ++z)
        for (unsigned y = 0; y < g.y; ++y)
          for (unsigned x = 0; x < g.x; ++x) {
            blockIdx = dim3(x, y, z);
            kernel(args...);
            done.arrive_and_wait();
          }
    });
  for (auto& t : threads) t.join();
}
}  // namespace emu

enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
union cudaLaunchAttributeValue {
  int programmaticStreamSerializationAllowed;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...),
                               A... args) {
  emu::launch(c->gridDim, c->blockDim, c->dynamicSmemBytes, c->stream, k,
              args...);
  return cudaSuccess;
}

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  emu::warp_buffer[w][l] = v;
  emu::warp_barrier[w]->arrive_and_wait();
  const float r = emu::warp_buffer[w][l ^ lane_mask];
  emu::warp_barrier[w]->arrive_and_wait();
  return r;
}

namespace emu {
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b, with the
// PTX fragment layout (g = lane / 4, t = lane % 4): a holds A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b holds B[t][g], B[t + 4][g];
// d holds D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]. One
// exchange through a per-warp buffer between two barriers of the warp; the
// operands lose the 13 low bits TF32 drops, and each sum is taken in k
// order in fp32 (the card's order and rounding inside an MMA are its own)
inline float mma_a[32][16][8], mma_b[32][8][8];
inline void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                             const uint32_t (&b)[2]) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, g = l / 4, t = l % 4;
  auto tf32 = [](uint32_t u) { return __uint_as_float(u & 0xffffe000u); };
  mma_a[w][g][t] = tf32(a[0]);
  mma_a[w][g + 8][t] = tf32(a[1]);
  mma_a[w][g][t + 4] = tf32(a[2]);
  mma_a[w][g + 8][t + 4] = tf32(a[3]);
  mma_b[w][t][g] = tf32(b[0]);
  mma_b[w][t + 4][g] = tf32(b[1]);
  warp_barrier[w]->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), c = 2 * t + i % 2;
    float s = d[i];
    for (int k = 0; k < 8; ++k) s += mma_a[w][r][k] * mma_b[w][k][c];
    d[i] = s;
  }
  warp_barrier[w]->arrive_and_wait();
}
// griddepcontrol.wait: the grid before has finished, grids run in turn
inline void griddepcontrol_wait() {}
}  // namespace emu
