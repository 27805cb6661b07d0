// Poseidon2 sponge over Baby Bear, one hash per thread (Hopper, sm_90a).
//
// Replaces the TPU Pallas kernels of boundless_tpu/core/poseidon2_pallas.py:
//   * _sponge_kernel_v2 (:358), launched by _sponge_v2 (:377), and
//   * _sponge_kernel (:195), launched by _sponge_t (:214),
// which compute the same function in two TPU layouts (v2: a vreg per state
// cell, v1: cells on sublanes). Here one function covers both, for any row
// count N >= 1 and any column count C >= 0: width 24, rate 16, x^7 S-box,
// 4 + 21 + 4 rounds, the last rate block zero-padded in-kernel (C = 0
// absorbs one zero block), an 8-word digest. An optional (N, 24) initial
// state turns the C = 0 call into one permutation of that state (the
// Fiat-Shamir transcript's absorbs), and `out_words` = 24 returns the
// whole state.
//
// What bounds it on this card: integer ALU work. Every 16 input words cost
// one permutation, about 29 rounds of S-boxes (4 Montgomery products each;
// 24 per external round, 1 per internal round) plus the linear layers (the
// 14-add M4 sequence and the chunk sums; 24 diagonal products and a 24-term
// sum per internal round): roughly 1,400 32x32->64 products per block.
// Memory traffic is 4 bytes read per input word against ~100 products, so
// the kernel sits far above the H100's ops:byte ridge.
// What the design does about it: each thread keeps its 24-word state in
// registers for the whole sponge (no shared memory, no round trips to
// device memory between rounds), the round constants and mu sit in
// __constant__ memory (every thread of a warp reads the same word, a
// broadcast), every round body is unrolled, and a product is one native
// wide multiply plus a Montgomery reduction (csrc/babybear.cuh). Rows are
// read row-major, so a warp's loads are strided by C words (uncoalesced);
// coalesced tiles through shared memory, and TMA, are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"

namespace {

constexpr int WIDTH = 24;
constexpr int RATE = 16;
constexpr int ROUNDS_HALF = 4;
constexpr int ROUNDS_PARTIAL = 21;

__constant__ uint32_t c_ext_rc[2 * ROUNDS_HALF * WIDTH];
__constant__ uint32_t c_int_rc[ROUNDS_PARTIAL];
__constant__ uint32_t c_mu[WIDTH];

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mul(x, x);
  uint32_t x3 = bb::mul(x2, x);
  uint32_t x6 = bb::mul(x3, x3);
  return bb::mul(x6, x);
}

// M4 @ (x0..x3) with the Poseidon2 paper's 14-add sequence, in place.
__device__ __forceinline__ void m4(uint32_t* x) {
  uint32_t t0 = bb::add(x[0], x[1]);
  uint32_t t1 = bb::add(x[2], x[3]);
  uint32_t t2 = bb::add(bb::add(x[1], x[1]), t1);
  uint32_t t3 = bb::add(bb::add(x[3], x[3]), t0);
  uint32_t d1 = bb::add(t1, t1);
  uint32_t t4 = bb::add(bb::add(d1, d1), t3);
  uint32_t d0 = bb::add(t0, t0);
  uint32_t t5 = bb::add(bb::add(d0, d0), t2);
  x[0] = bb::add(t3, t5);
  x[1] = t5;
  x[2] = bb::add(t2, t4);
  x[3] = t4;
}

// M_E = circ(2*M4, M4, ..., M4): M4 on each 4-chunk, plus the chunk sum.
__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int k = 0; k < WIDTH / 4; ++k) m4(s + 4 * k);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t t = bb::add(bb::add(bb::add(s[c], s[4 + c]),
                                 bb::add(s[8 + c], s[12 + c])),
                         bb::add(s[16 + c], s[20 + c]));
#pragma unroll
    for (int k = 0; k < WIDTH / 4; ++k) s[4 * k + c] = bb::add(s[4 * k + c], t);
  }
}

__device__ __forceinline__ void external_round(uint32_t* s, int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = sbox(bb::add(s[j], c_ext_rc[r * WIDTH + j]));
  external_linear(s);
}

// M_I = J + diag(mu): s_j <- mu_j * s_j + sum(s).
__device__ __forceinline__ void internal_round(uint32_t* s, int r) {
  s[0] = sbox(bb::add(s[0], c_int_rc[r]));
  uint32_t t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = bb::add(bb::add(s[j], s[8 + j]), s[16 + j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = bb::add(t[j], t[4 + j]);
  uint32_t sum = bb::add(bb::add(t[0], t[1]), bb::add(t[2], t[3]));
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = bb::add(bb::mul(s[j], c_mu[j]), sum);
}

// The round loops stay rolled: each round body is straight-line code over
// the register state, and nvcc 12.9's front end (cicc) crashes when all
// 29 rounds are unrolled into one body.
__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_HALF; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_PARTIAL; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = ROUNDS_HALF; r < 2 * ROUNDS_HALF; ++r) external_round(s, r);
}

__global__ void __launch_bounds__(128)
sponge_kernel(const uint32_t* __restrict__ in, long long n, int cols,
              const uint32_t* __restrict__ init, uint32_t* __restrict__ out,
              int out_words) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = init ? init[i * WIDTH + j] : 0u;
  const uint32_t* row = in + i * (long long)cols;
  const int blocks = cols > 0 ? (cols + RATE - 1) / RATE : 1;
  for (int b = 0; b < blocks; ++b) {
    const int c0 = b * RATE;
    if (c0 + RATE <= cols) {
#pragma unroll
      for (int j = 0; j < RATE; ++j) s[j] = bb::add(s[j], row[c0 + j]);
    } else {
#pragma unroll
      for (int j = 0; j < RATE; ++j)
        if (c0 + j < cols) s[j] = bb::add(s[j], row[c0 + j]);
    }
    permute(s);
  }
#pragma unroll
  for (int j = 0; j < WIDTH; ++j)
    if (j < out_words) out[i * out_words + j] = s[j];
}

}  // namespace

extern "C" {

// Copies the round constants (Montgomery words) to the current device.
int bt_p2_set_constants(const uint32_t* ext_rc, const uint32_t* int_rc,
                        const uint32_t* mu) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(c_ext_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(c_int_rc));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_mu, mu, sizeof(c_mu));
  return (int)e;
}

// Sponge over the rows of a contiguous row-major (n, cols) input; writes
// the first out_words state words of each row to a contiguous (n,
// out_words) output. `init` is null or a contiguous (n, 24) state.
// Returns cudaGetLastError() after the launch (0 on success).
int bt_p2_sponge(const uint32_t* in, long long n, int cols,
                 const uint32_t* init, uint32_t* out, int out_words,
                 void* stream) {
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  sponge_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, n, cols, init, out, out_words);
  return (int)cudaGetLastError();
}

}  // extern "C"
