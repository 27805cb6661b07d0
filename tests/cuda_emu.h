// Runs a CUDA source of the port on the CPU, for tests of its indexing and
// data movement (tests/test_torch_poseidon2_lanes.py builds
// csrc/poseidon2.cu with g++ against this header in place of
// <cuda_runtime.h>). One OS thread a CUDA thread, one block at a time;
// __syncthreads, __shfl_sync and __shfl_xor_sync meet at barriers, so a
// warp's lanes exchange values as on the card. Static __shared__ arrays
// become function statics and dynamic shared memory the array `smem`. It
// says nothing of timing, memory ordering beyond the barriers, or what
// nvcc accepts.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)

struct uint4 {
  unsigned x, y, z, w;
};
struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};

struct EmuWarp {
  std::barrier<> bar{32};
  unsigned vals[32];
};
inline std::vector<std::unique_ptr<EmuWarp>> emu_warps;
inline std::unique_ptr<std::barrier<>> emu_block;
inline uint32_t smem[1 << 17];  // dynamic shared memory of the running block

inline unsigned emu_exchange(unsigned v, int src_of_lane_xor, bool xor_mode) {
  EmuWarp& w = *emu_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  w.vals[lane] = v;
  w.bar.arrive_and_wait();
  const unsigned r =
      w.vals[xor_mode ? (lane ^ src_of_lane_xor) : src_of_lane_xor];
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return emu_exchange(v, src, false);
}
inline unsigned __shfl_xor_sync(unsigned, unsigned v, int mask) {
  return emu_exchange(v, mask, true);
}
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
template <class T>
T __ldg(const T* p) {
  return *p;
}
template <class T>
cudaError_t cudaMemcpyToSymbol(T& symbol, const void* src, size_t bytes) {
  memcpy(&symbol, src, bytes);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// kernel<<<grid, block, shared, stream>>>(args...) becomes
// emu_launch(grid, block, shared, kernel, args...).
template <class F, class... A>
void emu_launch(unsigned grid, unsigned block, size_t, F kernel, A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    emu_warps.clear();
    for (unsigned w = 0; w < block / 32; ++w)
      emu_warps.emplace_back(new EmuWarp());
    emu_block.reset(new std::barrier<>(block));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        kernel(args...);
        emu_block->arrive_and_drop();  // a returned thread waits on nothing
        emu_warps[t / 32]->bar.arrive_and_drop();
      });
    for (auto& t : threads) t.join();
  }
}
