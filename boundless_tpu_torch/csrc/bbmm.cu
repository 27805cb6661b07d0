// Exact Baby Bear weighted column sum on the int8 tensor cores (Hopper,
// sm_90a).
//
// Replaces boundless_tpu/core/bbmm.py _bb_ws_chunk (:108), reached through
// bb_weighted_sum (:71) and bb_weighted_sum_t (:90). For values V (M, K)
// and weights Wt (K, W), W = 4 or 8 (an extension element, or two: the
// widths the prover passes), both uint32 words (Montgomery words in [0, P)
// on the prover's path), it writes
//
//   out[m, j] = (sum_k V[m, k] * Wt[k, j]) * R^-1 mod P,  canonical,
//
// the word the reference's int8-limb matmuls on the TPU's matrix unit fold
// to: the sum of the Montgomery products V * Wt * R^-1. The sum is exact,
// so the word equals the reference's and the port's plain version's.
//
// V is a table of column blocks read in place: block b is a base pointer,
// a row stride ld_b (0: one row broadcast to all M) and a width, the
// widths adding up to K; its column k' is column off_b + k' of V, where
// off_b is the sum of the widths before it. A single row-major matrix is
// one block. So the callers pass the trees' matrices, an ext item's (M, 4)
// coordinates and single columns as they lie, and never concatenate them.
//
// The product. A word below 2^32 is four bytes in memory, so a staged
// (rows, K) tile of words is a (rows, 4K) u8 matrix, byte l of word k in
// column 4k + l: the A operand of the tensor cores' u8 product as it lies.
// The B operand B'[4k + l, (s, j)] = byte (s - l) of Wt[k, j] (0 outside
// 0..3), s = 0..6, makes the product
//
//   C[m, (s, j)] = sum_k sum_{l + l' = s} byte_l(V[m, k]) byte_l'(Wt[k, j]),
//
// and sum_s C_s 2^(8 s) = sum_k V[m, k] Wt[k, j] exactly. B' has 7 W
// columns: 7 n-tiles of 8 at W = 8, and 28 padded to 32 at W = 4. A
// thread's B' fragment register is one PRMT of a weight word (the bytes
// of s - 3..s, zero outside), built from the weights tile in shared
// memory for each 8-word K step. Columns are ordered so that one thread's
// accumulators hold every s of its outputs: at W = 8 column n = 8 s + j,
// at W = 4 n = 8 (s >> 1) + 2 j + (s & 1).
//
// Exactness. A word adds at most 4 * 255^2 to an s32 accumulator, so a
// block takes at most SLICE_MAX = 4096 words of K (under 2^30 in each
// C_s) and folds once, at its end: lo = sum_{s<4} C_s 2^(8s) < 2^55 and
// hi = sum_{s>=4} C_s 2^(8(s-4)) < 2^47, out = (lo + 2^32 hi) R^-1 =
// redc(lo) + hi = redc(lo) + bb::mul(redc(hi), R^2): three Montgomery
// reductions and an add, no division.
//
// What bounds it on this card: each word of V is read once (4 bytes); its
// 7 W u8 products a byte go to the tensor cores (at the main DEEP shape
// 2^18 x 480 x 8, 28 G u8 products, ~0.03 ms at the card's 1,979 TOP/s
// against 0.15 ms of bytes at 3.35 TB/s), so the bytes are the bound at
// every shape. For the bytes: a block owns BM = 64 rows (four warps, an
// m16 tile each) and walks its K slice in tiles of KT = 32 words through
// a ring of STAGES = 3 shared buffers filled by 4-byte cp.async (any row
// stride, any alignment), so the loads in flight live in shared memory,
// not registers, and a block has one barrier a tile. Only words inside
// the matrix are copied; the weights past the slice's end are zero
// filled, so what the buffers hold there multiplies zero. Staged rows are
// padded to KT + 4 words, which keeps ldmatrix's 16-byte row reads and
// the copies' stores on distinct banks. The copies' instructions, not
// the tensor cores, are the kernel's own work: a 16-byte cp.async would
// need 16-byte aligned rows, which an alpha-combine's single columns
// (row stride 1) are not. Few rows: when a call's row tiles would not give the
// card four blocks an SM, the wrapper splits K into slices over
// blockIdx.y; each block writes its canonical partial sum to an (S, M, W)
// workspace and a second launch adds the S partials mod P (exact, so the
// same word).
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"
#include "ptx.cuh"

namespace {

constexpr int BM = 64;               // rows a block: an m16 tile a warp
constexpr int WARPS = BM / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int KT = 32;               // words of K a stage
constexpr int STR = KT + 4;          // staged row stride (words)
constexpr int STAGES = 3;            // ring of cp.async buffers
constexpr unsigned SLICE_MAX = 4096; // words of K a block: exact s32 sums
constexpr int MAX_BLOCKS = 128;      // column blocks a call
constexpr int SUM_THREADS = 256;

constexpr uint32_t R2_MOD_P =
    (uint32_t)(((1ull << 32) % bb::P) * ((1ull << 32) % bb::P) % bb::P);

// One column block: columns [previous end, end) of V.
struct Block {
  const uint32_t* ptr;  // row 0, column 0 of the block
  long long ld;         // row stride in words (0: one broadcast row)
  unsigned end;
};

struct Args {
  Block blocks[MAX_BLOCKS];
  int nblocks;
  const uint32_t* w;  // (K, W) contiguous
  uint32_t* out;      // (S, M, W): the sums, or the slices' partial sums
  long long m_rows;
  unsigned k_cols;
  unsigned slice_cols;  // K a block: a multiple of KT, <= SLICE_MAX
};

// PRMT selector of B' for s: result byte l = byte (s - l) of the weight
// word, or byte 0 of the zero operand (selector 4) outside 0..3.
__host__ __device__ constexpr uint32_t sel_of(int s) {
  uint32_t r = 0;
  for (int l = 0; l < 4; ++l)
    r |= (uint32_t)(s - l >= 0 && s - l <= 3 ? s - l : 4) << (4 * l);
  return r;
}

// (sum_s c[s] 2^(8s)) * R^-1 mod P for the 7 accumulators of an output.
__device__ __forceinline__ uint32_t finish(const int (&c)[7]) {
  uint64_t lo = 0, hi = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) lo += (uint64_t)(uint32_t)c[s] << (8 * s);
#pragma unroll
  for (int s = 4; s < 7; ++s) hi += (uint64_t)(uint32_t)c[s] << (8 * (s - 4));
  return bb::add(bb::redc(lo), bb::mul(bb::redc(hi), R2_MOD_P));
}

template <int W>
__global__ void __launch_bounds__(THREADS)
    ws_mma_kernel(const __grid_constant__ Args a) {
  constexpr int NT = W == 8 ? 7 : 4;  // n-tiles of B'
  constexpr int RPT = BM / WARPS;     // rows a thread copies a tile
  __shared__ __align__(16) uint32_t vs[STAGES][BM * STR];
  __shared__ __align__(16) uint32_t ws[STAGES][KT * W];
  __shared__ Block tab[MAX_BLOCKS];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, q = lane % 4;
  const long long row0 = (long long)blockIdx.x * BM;
  const unsigned k_lo = blockIdx.y * a.slice_cols;
  const unsigned k_hi = min(a.k_cols, k_lo + a.slice_cols);
  const unsigned tiles = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  // rows this thread copies: warp, warp + WARPS, ... below M
  const long long left = a.m_rows - row0 - warp;
  const int rows = left >= RPT * WARPS ? RPT : (int)((left + WARPS - 1) / WARPS);
  for (int i = t; i < a.nblocks; i += THREADS) tab[i] = a.blocks[i];
  __syncthreads();

  // Stage a tile: this thread copies column `lane` of it for its rows,
  // and one or two of the tile's weight words. Weights past the slice are
  // zero-filled, so the values there (and in rows past M, which are never
  // stored) may keep whatever the buffer held: they multiply zero.
  int b = 0;  // the block of this thread's column (columns only grow)
  auto issue = [&](unsigned tile) {
    const int st = tile % STAGES;
    const unsigned k0 = k_lo + tile * KT, k = k0 + lane;
    if (k < k_hi) {
      while (b + 1 < a.nblocks && k >= tab[b].end) ++b;
      const long long ld = tab[b].ld;
      const uint32_t* src =
          tab[b].ptr + (k - (b ? tab[b - 1].end : 0u)) + (row0 + warp) * ld;
      uint32_t* dst = vs[st] + warp * STR + lane;
#pragma unroll
      for (int i = 0; i < RPT; ++i, src += WARPS * ld)
        if (i < rows) ptx::cp_async4(dst + i * WARPS * STR, src, true);
    }
#pragma unroll
    for (int i = t; i < KT * W; i += THREADS) {
      const bool full = k0 + i / W < k_hi;
      ptx::cp_async4(ws[st] + i, full ? a.w + (size_t)k0 * W + i : a.w, full);
    }
  };

  // B' selectors of this thread's column in each n-tile, and the weight
  // column j it reads.
  uint32_t sel[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    sel[n] = W == 8 ? sel_of(n) : (g & 1 ? sel_of(2 * n + 1) : sel_of(2 * n));
  const int jw = W == 8 ? g : g / 2;

  int c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if ((unsigned)s < tiles) issue(s);
    ptx::cp_async_commit();
  }
  // ldmatrix: lanes 0-7 give rows 0-7 of words 0-3 (a[0]), 8-15 rows 8-15
  // (a[1]), 16-23 rows 0-7 of words 4-7 (a[2]), 24-31 rows 8-15 (a[3]).
  const int a_off =
      (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 4;
  for (unsigned tile = 0; tile < tiles; ++tile) {
    ptx::cp_async_wait<STAGES - 2>();  // this thread's copies of `tile`
    __syncthreads();  // everyone's; and the buffer of tile - 1 is free
    if (tile + STAGES - 1 < tiles) issue(tile + STAGES - 1);
    ptx::cp_async_commit();
    const uint32_t* vt = vs[tile % STAGES];
    const uint32_t* wt = ws[tile % STAGES];
    const unsigned k_left = k_hi - (k_lo + tile * KT);
#pragma unroll
    for (int kk = 0; kk < KT; kk += 8) {
      if (kk >= (int)k_left) break;  // the same for the whole block
      uint32_t af[4];
      ptx::ldmatrix_x4(af, vt + a_off + kk);
      const uint32_t w0 = wt[(kk + q) * W + jw], w1 = wt[(kk + q + 4) * W + jw];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t bf[2] = {__byte_perm(w0, 0u, sel[n]),
                                __byte_perm(w1, 0u, sel[n])};
        ptx::mma_u8(c[n], af, bf);
      }
    }
  }

  // Rows g and g + 8 of the warp's tile; at W = 8 columns 2q and 2q + 1
  // (s = the n-tile), at W = 4 column q (s = 2 n-tile + column parity).
  uint32_t* out = a.out + (size_t)blockIdx.y * a.m_rows * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = row0 + warp * 16 + g + 8 * h;
    if (m >= a.m_rows) continue;
    if constexpr (W == 8) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        int cs[7];
#pragma unroll
        for (int s = 0; s < 7; ++s) cs[s] = c[s][2 * h + jj];
        out[m * W + 2 * q + jj] = finish(cs);
      }
    } else {
      int cs[7];
#pragma unroll
      for (int s = 0; s < 7; ++s) cs[s] = c[s / 2][2 * h + s % 2];
      out[m * W + q] = finish(cs);
    }
  }
}

// out[i] = sum_s part[s * n + i] mod P (canonical words).
__global__ void __launch_bounds__(SUM_THREADS)
    ws_sum_kernel(const uint32_t* part, uint32_t* out, long long n,
                  unsigned slices) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t s = part[i];
  for (unsigned j = 1; j < slices; ++j) s = bb::add(s, part[j * n + i]);
  out[i] = s;
}

template <int W>
int launch(Args& a, long long slices, uint32_t* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.m_rows + BM - 1) / BM), (unsigned)slices);
  ws_mma_kernel<W><<<grid, THREADS, 0, stream>>>(a);
  if (slices > 1) {
    const long long n = a.m_rows * W;
    const unsigned blocks = (unsigned)((n + SUM_THREADS - 1) / SUM_THREADS);
    ws_sum_kernel<<<blocks, SUM_THREADS, 0, stream>>>(a.out, out, n,
                                                      (unsigned)slices);
  }
  return (int)cudaGetLastError();
}

template <int W>
int blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ws_mma_kernel<W>, THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// The design's constants, for the wrapper to check: BM, KT, SLICE_MAX,
// MAX_BLOCKS.
void bt_bbmm_layout(int* out) {
  out[0] = BM;
  out[1] = KT;
  out[2] = (int)SLICE_MAX;
  out[3] = MAX_BLOCKS;
}

// Blocks of the W = width kernel that fit on one SM, or a negative CUDA
// error.
int bt_bbmm_blocks_per_sm(int width) {
  if (width == 4) return blocks_per_sm<4>();
  if (width == 8) return blocks_per_sm<8>();
  return -(int)cudaErrorInvalidValue;
}

// The contiguous (m_rows, width) `out`: the weighted sum of the column
// blocks (ptrs[b], lds[b], widths[b]), b < nblocks, and the contiguous
// (K, width) weights `w`, K = the sum of the widths: see above. Each block
// takes slice_cols columns of K (a multiple of KT, at most SLICE_MAX);
// with S = ceil(K / slice_cols) > 1 slices the (S, m_rows, width)
// `partial` holds their sums before a second launch adds them. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// width other than 4 or 8, more than MAX_BLOCKS blocks, K >= 2^32, or a
// slice_cols or S the kernel does not take.
int bt_bbmm(const void* const* ptrs, const long long* lds,
            const unsigned* widths, int nblocks, const uint32_t* w, int width,
            uint32_t* out, long long m_rows, unsigned slice_cols,
            uint32_t* partial, void* stream) {
  if ((width != 4 && width != 8) || nblocks < 0 || nblocks > MAX_BLOCKS ||
      slice_cols == 0 || slice_cols % KT || slice_cols > SLICE_MAX)
    return cudaErrorInvalidValue;
  Args a{};
  unsigned long long k = 0;
  for (int i = 0; i < nblocks; ++i) {
    k += widths[i];
    a.blocks[i] = Block{(const uint32_t*)ptrs[i], lds[i], (unsigned)k};
  }
  if (k >> 32) return cudaErrorInvalidValue;
  const long long slices = k ? (long long)((k + slice_cols - 1) / slice_cols) : 1;
  if (slices > 65535 || (slices > 1 && !partial)) return cudaErrorInvalidValue;
  if (m_rows <= 0) return cudaSuccess;
  a.nblocks = nblocks;
  a.w = w;
  a.out = slices > 1 ? partial : out;
  a.m_rows = m_rows;
  a.k_cols = (unsigned)k;
  a.slice_cols = slice_cols;
  const cudaStream_t s = (cudaStream_t)stream;
  return width == 4 ? launch<4>(a, slices, out, s) : launch<8>(a, slices, out, s);
}

}  // extern "C"
