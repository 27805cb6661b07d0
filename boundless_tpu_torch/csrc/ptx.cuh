// The inline PTX of the port's tensor-core kernels, behind a few device
// functions: the int8 tensor-core product, ldmatrix and cp.async with its
// groups (sm_80 and later; built for sm_90a).
//
// tests/cuda_emu.h defines BT_CUDA_EMU and gives the same functions as
// exact C++ emulations (the fragment layouts gathered across the emulated
// warp, the copies held until their group is waited on), so a kernel that
// calls only these runs under g++ on the CPU as it does on the card.
#pragma once

#include <stdint.h>

#ifndef BT_CUDA_EMU

namespace ptx {

// d += A B for one warp: A a 16 x 32 u8 tile (row-major), B a 32 x 8 u8
// tile (column-major), d 16 x 8 s32. The fragments are the PTX ISA's for
// mma.m16n8k32 with .u8 operands (lane = 4 g + q):
//   a[0] = A[g][4q..4q+3],  a[1] = A[g+8][4q..4q+3],
//   a[2] = A[g][16+4q..],   a[3] = A[g+8][16+4q..]   (byte i = column +i);
//   b[0] = B[4q..4q+3][g],  b[1] = B[16+4q..16+4q+3][g];
//   d[0], d[1] = D[g][2q], D[g][2q+1];  d[2], d[3] = D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i..8i+7 give the
// 16-byte rows of matrix i, and r[i] of lane 4 g + q is the 32-bit word q
// of row g of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint32_t* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// An asynchronous 4-byte copy from global to shared memory; when `full` is
// false nothing is read and the word is written as zero.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          bool full) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 4 : 0));
}

// Closes the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
// Other threads' copies are seen only after a __syncthreads that follows.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace ptx

#endif  // BT_CUDA_EMU
