// Runs a CUDA source of the port on the CPU, for tests of its indexing and
// data movement (tests/test_torch_poseidon2_lanes.py builds
// csrc/poseidon2.cu with g++ against this header in place of
// <cuda_runtime.h>). One OS thread a CUDA thread, one block at a time;
// __syncthreads, __shfl_sync and __shfl_xor_sync meet at barriers, so a
// warp's lanes exchange values as on the card. Static __shared__ arrays
// become function statics and dynamic shared memory the array `smem`. It
// says nothing of timing, memory ordering beyond the barriers, or what
// nvcc accepts.
//
// It also gives exact emulations of csrc/ptx.cuh's wrappers of inline PTX
// (and defines BT_CUDA_EMU, which leaves the PTX out): the int8 tensor-core
// product and ldmatrix gather every lane's fragment or row address through
// a warp exchange and apply the PTX ISA's layouts (m16n8k32 .u8 A, B and
// C fragments; ldmatrix .x4 .b16 rows); a cp.async is queued in its
// thread's open group, a commit closes the group, and cp_async_wait<N>
// performs the thread's oldest groups until N are left, so a kernel that
// reads a staged word before waiting for it reads the old word.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>
#include <deque>
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
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))
#define BT_CUDA_EMU 1

struct uint4 {
  unsigned x, y, z, w;
};
struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local EmuDim threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaStreamNonBlocking = 1,
  cudaEventDisableTiming = 2,
  cudaMemcpyHostToDevice = 1
};

struct EmuWarp {
  std::barrier<> bar{32};
  unsigned vals[32];
  alignas(16) unsigned char bytes[32][32];  // emu_gather's exchange
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
// Every lane's `mine`, in lane order, to every lane of the warp.
template <class T>
void emu_gather(const T& mine, T (&all)[32]) {
  static_assert(sizeof(T) <= sizeof(EmuWarp::bytes[0]), "gather too wide");
  EmuWarp& w = *emu_warps[threadIdx.x / 32];
  memcpy(w.bytes[threadIdx.x % 32], &mine, sizeof(T));
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) memcpy(&all[i], w.bytes[i], sizeof(T));
  w.bar.arrive_and_wait();
}
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long xy = (unsigned long long)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)(xy >> (8 * ((s >> (4 * n)) & 7)) & 0xff) << (8 * n);
  return r;
}
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

// Streams and events: a launch or a copy runs to its end when it is called,
// so every order a stream or an event would keep is kept. A 2-D copy is a
// memcpy a row on host memory, counted with its bytes (emu_copies).
inline long long emu_copy_count = 0, emu_copy_bytes = 0;
extern "C" void emu_copies(long long* out) {
  out[0] = emu_copy_count;
  out[1] = emu_copy_bytes;
}
inline cudaError_t cudaStreamCreateWithFlags(cudaStream_t* s, unsigned) {
  *s = (cudaStream_t)1;
  return cudaSuccess;
}
inline cudaError_t cudaStreamDestroy(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) {
  *e = (cudaEvent_t)1;
  return cudaSuccess;
}
inline cudaError_t cudaEventDestroy(cudaEvent_t) { return cudaSuccess; }
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) {
  return cudaSuccess;
}
inline cudaError_t cudaStreamWaitEvent(cudaStream_t, cudaEvent_t, unsigned) {
  return cudaSuccess;
}
inline cudaError_t cudaMemcpy2DAsync(void* dst, size_t dpitch,
                                     const void* src, size_t spitch,
                                     size_t width, size_t height, int,
                                     cudaStream_t) {
  for (size_t r = 0; r < height; ++r)
    memcpy((char*)dst + r * dpitch, (const char*)src + r * spitch, width);
  ++emu_copy_count;
  emu_copy_bytes += (long long)(width * height);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;  // one block at a time
  return cudaSuccess;
}

// csrc/ptx.cuh's wrappers (see above).
struct EmuCopy {
  uint32_t* dst;
  const uint32_t* src;
  bool full;
};
inline thread_local std::vector<EmuCopy> emu_open_group;
inline thread_local std::deque<std::vector<EmuCopy>> emu_groups;

namespace ptx {

inline void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                   const uint32_t (&b)[2]) {
  struct Frag {
    uint32_t a[4], b[2];
  };
  Frag all[32];
  emu_gather(Frag{{a[0], a[1], a[2], a[3]}, {b[0], b[1]}}, all);
  uint8_t A[16][32], B[32][8];
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane / 4, q = lane % 4;
    for (int i = 0; i < 4; ++i) {
      A[g][4 * q + i] = (uint8_t)(all[lane].a[0] >> (8 * i));
      A[g + 8][4 * q + i] = (uint8_t)(all[lane].a[1] >> (8 * i));
      A[g][16 + 4 * q + i] = (uint8_t)(all[lane].a[2] >> (8 * i));
      A[g + 8][16 + 4 * q + i] = (uint8_t)(all[lane].a[3] >> (8 * i));
      B[4 * q + i][g] = (uint8_t)(all[lane].b[0] >> (8 * i));
      B[16 + 4 * q + i][g] = (uint8_t)(all[lane].b[1] >> (8 * i));
    }
  }
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * q + i % 2;
    uint32_t sum = (uint32_t)d[i];  // s32 sums wrap as the card's do
    for (int k = 0; k < 32; ++k) sum += (uint32_t)A[row][k] * B[k][col];
    d[i] = (int)sum;
  }
}

inline void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* row) {
  const uint32_t* rows[32];
  emu_gather(row, rows);
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) r[i] = rows[8 * i + lane / 4][lane % 4];
}

inline void cp_async4(uint32_t* dst, const uint32_t* src, bool full) {
  emu_open_group.push_back(EmuCopy{dst, src, full});
}

inline void cp_async_commit() {
  emu_groups.push_back(std::move(emu_open_group));
  emu_open_group.clear();
}

template <int N>
void cp_async_wait() {
  while (emu_groups.size() > (size_t)N) {
    for (const EmuCopy& c : emu_groups.front())
      *c.dst = c.full ? *c.src : 0u;
    emu_groups.pop_front();
  }
}

}  // namespace ptx

// kernel<<<grid, block, shared, stream>>>(args...) becomes
// emu_launch(grid, block, shared, kernel, args...).
template <class F, class... A>
void emu_launch(dim3 grid, unsigned block, size_t, F kernel, A... args) {
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    emu_warps.clear();
    for (unsigned w = 0; w < block / 32; ++w)
      emu_warps.emplace_back(new EmuWarp());
    emu_block.reset(new std::barrier<>(block));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b % grid.x;
        blockIdx.y = b / grid.x;
        blockDim.x = block;
        gridDim.x = grid.x;
        gridDim.y = grid.y;
        kernel(args...);
        emu_block->arrive_and_drop();  // a returned thread waits on nothing
        emu_warps[t / 32]->bar.arrive_and_drop();
      });
    for (auto& t : threads) t.join();
  }
}
