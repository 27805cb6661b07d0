"""A probe of the int8 tensor-core product and ldmatrix wrappers
(`boundless_tpu_torch/csrc/ptx.cuh`): `MMA_PROBE` is a CUDA source with
the C entry `bt_mma_probe(A, B, C, D, E, stream)` that one warp runs, and
`mma_case(seed)` its inputs and the numpy u8 product they must give.
`tests/test_torch_bbmm.py` builds the probe against `tests/cuda_emu.h`;
`tests/test_torch_kernels_cuda.py` builds it with nvcc on the card.
"""

import numpy as np

MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

__device__ uint32_t word_at(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

// One warp: D = A B + C and E = A B + C for a row-major (16, 32) u8 A, a
// (32, 8) u8 B stored by columns (B[32 n + k]) and a row-major (16, 8) s32
// C. D takes A's fragments from global memory by the PTX ISA's m16n8k32
// table, E through ldmatrix from a row-major tile in shared memory.
__global__ void mma_probe_kernel(const uint8_t* A, const uint8_t* B,
                                 const int* C, int* D, int* E) {
  __shared__ __align__(16) uint32_t tile[16 * 12];
  const int lane = threadIdx.x, g = lane / 4, q = lane % 4;
  const uint32_t a[4] = {word_at(A + 32 * g + 4 * q),
                         word_at(A + 32 * (g + 8) + 4 * q),
                         word_at(A + 32 * g + 16 + 4 * q),
                         word_at(A + 32 * (g + 8) + 16 + 4 * q)};
  const uint32_t b[2] = {word_at(B + 32 * g + 4 * q),
                         word_at(B + 32 * g + 16 + 4 * q)};
  int d[4], e[4];
  for (int i = 0; i < 4; ++i)
    d[i] = e[i] = C[8 * (g + 8 * (i / 2)) + 2 * q + i % 2];
  ptx::mma_u8(d, a, b);
  for (int i = lane; i < 16 * 8; i += 32)
    tile[i / 8 * 12 + i % 8] = word_at(A + 4 * i);
  __syncthreads();
  uint32_t al[4];
  ptx::ldmatrix_x4(
      al, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * 12 + (lane >> 4) * 4);
  ptx::mma_u8(e, al, b);
  for (int i = 0; i < 4; ++i) {
    D[8 * (g + 8 * (i / 2)) + 2 * q + i % 2] = d[i];
    E[8 * (g + 8 * (i / 2)) + 2 * q + i % 2] = e[i];
  }
}

extern "C" int bt_mma_probe(const uint8_t* A, const uint8_t* B,
                            const int* C, int* D, int* E, void* stream) {
  mma_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(A, B, C, D, E);
  return (int)cudaGetLastError();
}
"""


def mma_case(seed):
    """(A (16, 32) u8, B (32, 8) u8, C (16, 8) s32, A B + C)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(16, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(32, 8), dtype=np.uint8)
    c = rng.integers(-2**20, 2**20, size=(16, 8), dtype=np.int32)
    a[0], b[:, 0] = 255, 255  # the largest byte products
    return a, b, c, a.astype(np.int64) @ b.astype(np.int64) + c
