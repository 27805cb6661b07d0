// Poseidon over the BN254 scalar field (the p254 hash suite) on Hopper
// (sm_90a): row hashes of Baby Bear matrices and 2-to-1 compressions of
// digests, one thread a hash.
//
// Replaces the host hashing of the reference's p254 suite, which has no
// TPU kernel: boundless_tpu/core/poseidon_bn254.py hash_rows_np (:189) and
// hash_pairs_np (:198), reached through core/suites.py _hash_rows254 (:61)
// and _hash_pairs254 (:69) as jax.pure_callback host calls, one Python-int
// permutation at a time. The function is the same: t = 3, rate 2, x^5,
// 4 full + 57 partial + 4 full rounds, the Cauchy MDS; a row of C Baby
// Bear words (Montgomery, as the prover stores them) is taken out of
// Montgomery form, packed 8 to a felt in little-endian 31-bit slots
// (pack_bb), zero-padded to an even felt count (at least one felt) and
// absorbed two felts a permutation by field addition into state[0] and
// state[1]; the digest is state[0] as 8 little-endian u32 words, a
// canonical felt below r. A pair hash is one permutation of [a, b, 0].
//
// What bounds it on this card. Its multiplications: 828 Montgomery
// products a permutation (65 rounds: 3 products an S-box, 24 full-round and
// 57 partial-round S-boxes, and 9 MDS products a round), each 128
// 32x32->64 products (csrc/bn254_field.cuh), so ~106,000 wide products a
// permutation against 64 bytes of input (8 Baby Bear words a felt, two
// felts a permutation): far above the H100's ops:byte ridge, bound by the
// 32-bit multiply-add issue rate.
//
// What the design does about it, in this first version. One thread a hash
// keeps the 3-felt state in registers through the sponge; round constants
// and the MDS sit in __constant__ memory in Montgomery form, read
// uniformly by a warp (a broadcast). The round loop stays rolled (nvcc
// 12.9's front end crashed on a fully unrolled Baby Bear Poseidon2); the
// limb loops are unrolled. Lazy reduction in the MDS (9 products into 3
// reductions) and a tree top in one block are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"
#include "bn254_field.cuh"

namespace {

constexpr int T = 3;
constexpr int ROUNDS_FULL_HALF = 4;
constexpr int ROUNDS_PARTIAL = 57;
constexpr int ROUNDS = 2 * ROUNDS_FULL_HALF + ROUNDS_PARTIAL;
constexpr int PACK = 8;  // Baby Bear words a felt
constexpr int THREADS = 128;

using bn254::Fr;

__constant__ uint32_t c_rc[ROUNDS * T * 8];  // Montgomery, round-major
__constant__ uint32_t c_mds[T * T * 8];      // Montgomery, row-major

__device__ __forceinline__ void load_const(uint32_t r[8], const uint32_t* c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = c[k];
}

__device__ __forceinline__ void sbox(uint32_t x[8]) {
  uint32_t x2[8], x4[8];
  bn254::mul<Fr>(x2, x, x);
  bn254::mul<Fr>(x4, x2, x2);
  bn254::mul<Fr>(x, x4, x);
}

__device__ void permute(uint32_t s[T][8]) {
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t rc[8];
      load_const(rc, c_rc + (r * T + i) * 8);
      bn254::add<Fr>(s[i], s[i], rc);
    }
    sbox(s[0]);
    if (r < ROUNDS_FULL_HALF || r >= ROUNDS_FULL_HALF + ROUNDS_PARTIAL) {
      sbox(s[1]);
      sbox(s[2]);
    }
    uint32_t out[T][8];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        uint32_t m[8], p[8];
        load_const(m, c_mds + (i * T + j) * 8);
        bn254::mul<Fr>(p, m, s[j]);
        if (j == 0) {
          bn254::copy(out[i], p);
        } else {
          bn254::add<Fr>(out[i], out[i], p);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i) bn254::copy(s[i], out[i]);
  }
}

// Felt f of a row (its words 8f .. 8f+7, zero past the row's end) in
// Montgomery form: canonical Baby Bear words in 31-bit slots.
__device__ __forceinline__ void pack_felt(const uint32_t* row, int cols, int f,
                                          uint32_t felt[8]) {
  uint64_t acc = 0;
  int bits = 0, k = 0;
#pragma unroll
  for (int i = 0; i < PACK; ++i) {
    const int c = f * PACK + i;
    const uint32_t e = c < cols ? bb::mul(row[c], 1u) : 0u;  // canonical
    acc |= (uint64_t)e << bits;
    bits += 31;
    if (bits >= 32) {
      felt[k++] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
  felt[k] = (uint32_t)acc;  // k == 7: the top 24 bits
  bn254::to_mont<Fr>(felt, felt);
}

__device__ __forceinline__ void store_digest(uint32_t* out,
                                             const uint32_t s0[8]) {
  uint32_t d[8];
  bn254::from_mont<Fr>(d, s0);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = d[k];
}

__global__ void __launch_bounds__(THREADS)
    rows_kernel(const uint32_t* __restrict__ in, long long n, int cols,
                uint32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* x = in + row * cols;
  uint32_t s[T][8];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) s[i][k] = 0;
  const int felts = cols > 0 ? (cols + PACK - 1) / PACK : 1;
  const int blocks = (felts + 1) / 2;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t felt[8];
      pack_felt(x, cols, 2 * b + h, felt);
      bn254::add<Fr>(s[h], s[h], felt);
    }
    permute(s);
  }
  store_digest(out + row * 8, s[0]);
}

// in: (m, 16) rows [left digest | right digest], canonical felt words.
__global__ void __launch_bounds__(THREADS)
    pairs_kernel(const uint32_t* __restrict__ in, long long m,
                 uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t s[T][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[h][k] = in[i * 16 + h * 8 + k];
    bn254::to_mont<Fr>(s[h], s[h]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) s[2][k] = 0;
  permute(s);
  store_digest(out + i * 8, s[0]);
}

unsigned grid_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// Copies the round constants ((65, 3) felts) and the MDS ((3, 3) felts),
// Montgomery form as 8 little-endian u32 limbs each, to the current device.
int bt_p254_set_constants(const uint32_t* rc, const uint32_t* mds) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_mds, mds, sizeof(c_mds));
  return (int)e;
}

// Digests of the rows of a contiguous (n, cols) matrix of Montgomery Baby
// Bear words into a contiguous (n, 8) output. Returns cudaGetLastError().
int bt_p254_rows(const uint32_t* in, long long n, int cols, uint32_t* out,
                 void* stream) {
  rows_kernel<<<grid_of(n), THREADS, 0, (cudaStream_t)stream>>>(in, n, cols,
                                                                out);
  return (int)cudaGetLastError();
}

// Pair hashes of a contiguous (m, 16) input ([left | right] digest words)
// into a contiguous (m, 8) output. Returns cudaGetLastError().
int bt_p254_pairs(const uint32_t* in, long long m, uint32_t* out,
                  void* stream) {
  pairs_kernel<<<grid_of(m), THREADS, 0, (cudaStream_t)stream>>>(in, m, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
