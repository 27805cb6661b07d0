// Exact Baby Bear weighted column sum (Hopper, sm_90a).
//
// Replaces boundless_tpu/core/bbmm.py _bb_ws_chunk (:108), reached through
// bb_weighted_sum (:71) and bb_weighted_sum_t (:90). For values V (M, K)
// and weights Wt (K, W), W = 4 or 8 (an extension element, or two: the
// widths the prover passes), both uint32 words below 2^31 (Montgomery
// words in [0, P) on the prover's path), it writes
//
//   out[m, j] = (sum_k V[m, k] * Wt[k, j]) * R^-1 mod P,  canonical,
//
// the word the reference's int8-limb matmuls on the TPU's matrix unit fold
// to: the sum of the Montgomery products V * Wt * R^-1. The sum is exact,
// so the word equals the reference's and the port's plain version's.
//
// Layout: V is read in place, row-major (M, K) with a row stride `ld`
// (column slices and row steps of a larger matrix are views with ld > K).
// There is no transposed (K, M) layout: the one caller that passes one,
// bb_weighted_sum_t (the eager α-combine of the (K, M) constraint rows),
// runs only on the CPU, since the constraint kernel combines its own rows.
// Offsets are 64-bit: a recursion combine passes M * K >= 2^31.
//
// What bounds it on this card: each element of V is read once (4 bytes)
// and takes part in W products, so a call moves 4 M K bytes and does M K W
// 32x32->64 products. At one FMA-pipe issue a product (64 a clock an SM)
// the products of an element take at most 8 issues for 4 bytes, so the
// bytes at 3.35 TB/s are the bound at W = 4 and 8 (at W = 8 the two are
// within a factor of 2.5). The design keeps the arithmetic to about that
// least work: a product is one IMAD.WIDE.U32 that adds into a 64-bit group
// sum (four products below 2^62 fit in 64 bits), each group of four is
// folded into a 96-bit sum (a 64-bit word and a carry count) with three
// adds, and the one reduction mod P and the one R^-1 are taken once a sum,
// at the end. For the bytes: each block owns ROWS rows, one a thread, with
// the W sums in registers, and walks K in tiles of KT columns; the next
// tile's words are loaded into registers while the block computes on the
// current one, so a block keeps a tile of loads in flight through its
// arithmetic. The weights of a tile go to shared memory and are read as
// 16-byte broadcasts. 32 lanes on 32 rows of one column would read 32
// sectors, so the values tile is staged through shared memory (a warp
// loads 32 consecutive columns of a row, one 128-byte run; the rows
// padded to KT + 1 words keep both the stores and the per-row reads on 32
// banks). A launch has one block per ROWS rows, so a call of few rows
// (KeccakAir's 2^11 and 2^12) fills few SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"

namespace {

constexpr int ROWS = 128;    // rows a block, one a thread
constexpr int KT = 32;       // columns of V a tile
constexpr int PAD = KT + 1;  // staged row stride (words)
constexpr int GROUP = 4;     // products summed in 64 bits before a fold

constexpr uint64_t R_MOD_P = (1ull << 32) % bb::P;
constexpr uint64_t R2_MOD_P = R_MOD_P * R_MOD_P % bb::P;  // 2^64 mod P

struct Args {
  const uint32_t* v;  // (M, K) row-major, row stride ld
  long long ld;
  const uint32_t* w;  // (K, width) contiguous
  uint32_t* out;      // (M, width) contiguous
  long long m_rows;
  unsigned k_cols;
};

// 96-bit running sum of one output: lo + 2^64 * hi.
struct Acc {
  uint64_t lo;
  uint32_t hi;
};

__device__ __forceinline__ void fold(Acc& a, uint64_t group) {
  const uint64_t s = a.lo + group;
  a.hi += s < group;
  a.lo = s;
}

// (lo + 2^64 hi) * R^-1 mod P, canonical.
__device__ __forceinline__ uint32_t finish(const Acc& a) {
  const uint64_t r = (uint64_t)a.hi * R2_MOD_P + a.lo % bb::P;  // < 2^63
  return bb::mul((uint32_t)(r % bb::P), 1u);
}

// One block: rows [row0, row0 + ROWS). `vs` is the staged values tile,
// `ws` the weights tile as 16-byte vectors.
template <int W>
__device__ __forceinline__ void weighted_sum(const Args& a, uint32_t* vs,
                                             uint4* ws) {
  constexpr int WV = W / 4;             // 16-byte weight vectors a column
  constexpr int WT = KT * W;            // weight words a tile
  constexpr int WPT = (WT + ROWS - 1) / ROWS;  // of them a thread loads
  constexpr int WARPS = ROWS / 32;
  constexpr int VPT = ROWS / WARPS;     // values a thread loads
  const unsigned t = threadIdx.x;
  const unsigned lane = t % 32, warp = t / 32;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long m = row0 + t;
  const bool live = m < a.m_rows;
  uint32_t* wsw = reinterpret_cast<uint32_t*>(ws);
  Acc acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = Acc{0, 0};

  // The next tile's words, loaded into registers while the block computes
  // on the current one: a warp reads 32 consecutive columns of rows warp,
  // warp + WARPS, ... Past the matrix: zero.
  uint32_t wbuf[WPT], vbuf[VPT];
  auto fetch = [&](unsigned k0) {
    const unsigned kn = min((unsigned)KT, a.k_cols - k0);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const unsigned idx = t + i * ROWS;
      wbuf[i] = (idx < (unsigned)WT && idx / W < kn)
                    ? a.w[(size_t)k0 * W + idx] : 0u;
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const long long mr = row0 + warp + i * WARPS;
      vbuf[i] = (mr < a.m_rows && lane < kn)
          ? a.v[mr * a.ld + k0 + lane] : 0u;
    }
  };

  if (a.k_cols) fetch(0);
  for (unsigned k0 = 0; k0 < a.k_cols; k0 += KT) {
    const unsigned kn = min((unsigned)KT, a.k_cols - k0);
#pragma unroll
    for (int i = 0; i < WPT; ++i)
      if (t + i * ROWS < (unsigned)WT) wsw[t + i * ROWS] = wbuf[i];
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      vs[(warp + i * WARPS) * PAD + lane] = vbuf[i];
    __syncthreads();
    if (k0 + KT < a.k_cols) fetch(k0 + KT);
#pragma unroll
    for (int g = 0; g < KT; g += GROUP) {
      if (g >= (int)kn) break;  // the same for the whole block
      uint64_t grp[W];
#pragma unroll
      for (int j = 0; j < W; ++j) grp[j] = 0;
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const int k = g + q;
        const uint32_t x = vs[t * PAD + k];  // zero past kn
        uint32_t wk[4 * WV];
#pragma unroll
        for (int c = 0; c < WV; ++c) {
          const uint4 u = ws[k * WV + c];
          wk[4 * c] = u.x;
          wk[4 * c + 1] = u.y;
          wk[4 * c + 2] = u.z;
          wk[4 * c + 3] = u.w;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) grp[j] += (uint64_t)x * wk[j];
      }
#pragma unroll
      for (int j = 0; j < W; ++j) fold(acc[j], grp[j]);
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < W; ++j) a.out[m * W + j] = finish(acc[j]);
}

template <int W>
__global__ void __launch_bounds__(ROWS) ws_rows(Args a) {
  __shared__ uint32_t vs[ROWS * PAD];
  __shared__ uint4 ws[KT * W / 4];
  weighted_sum<W>(a, vs, ws);
}

template <int W>
void launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.m_rows + ROWS - 1) / ROWS);
  ws_rows<W><<<grid, ROWS, 0, stream>>>(a);
}

}  // namespace

extern "C" {

// The contiguous (m_rows, width) `out`: the weighted sum of the
// (m_rows, k_cols) values `v` (row-major with row stride ld) and the
// contiguous (k_cols, width) weights `w`: see above. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a width
// other than 4 or 8).
int bt_bbmm(const uint32_t* v, long long ld, const uint32_t* w, int width,
            uint32_t* out, long long m_rows, unsigned k_cols, void* stream) {
  const Args a{v, ld, w, out, m_rows, k_cols};
  const cudaStream_t s = (cudaStream_t)stream;
  if (m_rows <= 0) return cudaSuccess;
  if (width == 4)
    launch<4>(a, s);
  else if (width == 8)
    launch<8>(a, s);
  else
    return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
