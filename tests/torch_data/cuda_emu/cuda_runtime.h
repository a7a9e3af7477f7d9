// A CPU stand-in for the parts of the CUDA runtime that the port's kernel
// sources use, so that g++ can compile them and a test can run them:
// each CTA runs as one OS thread per CUDA thread, with real barriers for
// __syncthreads, __syncwarp and the warp collectives.  Blocks run one
// after another.  For testing the kernels' logic only: expf/logf here are
// glibc's, which round differently from the card's.
#pragma once

#include <math.h>

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

using std::fmaxf;
using std::fminf;
using std::isinf;
using std::isnan;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int EMU_SMEM_LIMIT = 232448;  // an H100's opt-in per block

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > EMU_SMEM_LIMIT ? cudaErrorInvalidValue : cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated CUDA error"; }

inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}

alignas(16) inline unsigned char emu_smem[EMU_SMEM_LIMIT];
inline std::barrier<>* emu_cta_barrier;
inline std::barrier<>* emu_warp_barrier[32];
inline std::atomic<int> emu_vote[2];
inline thread_local int emu_votes_cast;
inline float emu_lanes_f[1024];
inline int emu_lanes_i[1024];

inline void __syncthreads() { emu_cta_barrier->arrive_and_wait(); }
inline void __syncwarp() { emu_warp_barrier[threadIdx.x / 32]->arrive_and_wait(); }

inline int __syncthreads_or(int v) {
  const int round = emu_votes_cast++ & 1;
  if (v) emu_vote[round].store(1);
  __syncthreads();
  const int any = emu_vote[round].load();
  if (threadIdx.x == 0) emu_vote[round ^ 1].store(0);
  __syncthreads();
  return any;
}

inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int t = threadIdx.x;
  __syncwarp();
  emu_lanes_f[t] = v;
  __syncwarp();
  const float got = emu_lanes_f[(t & ~31) | ((t & 31) ^ mask)];
  __syncwarp();
  return got;
}

inline int __any_sync(unsigned, int v) {
  const int t = threadIdx.x;
  __syncwarp();
  emu_lanes_i[t] = v != 0;
  __syncwarp();
  int any = 0;
  for (int i = 0; i < 32; ++i) any |= emu_lanes_i[(t & ~31) | i];
  __syncwarp();
  return any;
}

// kernel<<<grid, threads, smem, stream>>>(args...) as the test's source
// rewrite spells it; shared memory is poisoned before each block, so a
// read of anything the block did not write shows.
template <class K, class... Args>
void emu_launch(K kernel, dim3 grid, int threads, Args... args) {
  std::barrier<> cta(threads);
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  for (int w = 0; w < threads / 32; ++w) {
    warps.emplace_back(new std::barrier<>(32));
    emu_warp_barrier[w] = warps.back().get();
  }
  emu_cta_barrier = &cta;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      emu_vote[0] = 0;
      emu_vote[1] = 0;
      std::memset(emu_smem, 0xAB, sizeof emu_smem);
      std::vector<std::thread> block;
      for (int t = 0; t < threads; ++t)
        block.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          emu_votes_cast = 0;
          kernel(args...);
        });
      for (auto& th : block) th.join();
    }
}
