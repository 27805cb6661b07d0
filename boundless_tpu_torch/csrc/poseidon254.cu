// Poseidon over the BN254 scalar field (the p254 hash suite) on Hopper
// (sm_90a): row hashes of Baby Bear matrices, 2-to-1 compressions of
// digests, a Merkle tree's top levels in one block, and whole opened paths
// in one launch; one thread a hash, or one hash over 3 lanes of a warp.
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
// What bounds it on this card. Throughput: its multiplications, each a
// Montgomery product of 8 x 32-bit limbs (csrc/bn254_field.cuh), far
// above the ops:byte ridge (64 bytes in a permutation). Latency: the
// permutations of a hash are a chain, and so are the levels of a tree and
// of an opened path; in a permutation every round waits on the one before,
// and a round on its S-box (three dependent products). A launch of a few
// rows is one warp's dependent chain, and the card idles around it.
//
// What the design does about it.
//  * Fewer products a permutation (kernels/poseidon254.schedule_table
//    derives the constants exactly from the reference's): each row of the
//    MDS is one mul_sum (three products summed wide, one reduction); the
//    partial rounds take the sparse-matrix form of the Poseidon paper
//    (Grassi et al., USENIX Security 2021, appendix B): the round
//    constants of the 57 partial rounds move back to one scalar a round,
//    added after the S-box, and a vector added after the S-boxes of round
//    3; each partial round's matrix is S_p (first row and column full, the
//    rest the identity), and round 3 applies the dense M_pre. A partial
//    round is the S-box, one mul_sum for s0 and one product and add for
//    each of s1, s2 (8 products, 5 reductions, where the dense form had 12
//    and 12).
//  * One thread a hash (lanes 1) where a launch fills the card: the state
//    stays in registers through the sponge.
//  * 3 lanes a hash (lanes 3) where it does not (the wrapper picks by row
//    count): lane l holds felt l. In a full round the three S-boxes run
//    side by side and each lane computes its own MDS row (the other felts
//    by __shfl_sync of 8 words); in a partial round every lane runs the
//    S-box (only lane 0's is kept) and then one uniform mul_sum over the
//    lane's row of the sparse matrix (lane 0: n00, w1, w2; lanes 1, 2:
//    their first-column entry, 1 and 0), so no lane branches. A warp holds
//    10 hashes (lanes 30 and 31 idle), a launch 3x the threads.
//  * A tree's top levels (a level of at most TREE_TOP nodes up to the
//    root) in one launch of one block (tree_kernel, 3 lanes a pair): the
//    level sits in shared memory in Montgomery form, each level above is
//    hashed from there, written out, and a __syncthreads() separates the
//    levels.
//  * An opened path walked in one launch (paths_kernel, 3 lanes a query):
//    the node stays in Montgomery form from level to level; the wrapper
//    checks every sibling below r once a call.
// The constants are one table in device memory (read by __ldg, cached in
// L1: lanes read different words). Round loops stay rolled: nvcc 12.9's
// front end (cicc) crashed on a fully unrolled permutation.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"
#include "bn254_field.cuh"

namespace {

constexpr int T = 3;
constexpr int ROUNDS_FULL_HALF = 4;
constexpr int ROUNDS_PARTIAL = 57;
constexpr int PACK = 8;  // Baby Bear words a felt
constexpr int THREADS = 128;
constexpr int GROUPS = 10;  // 3-lane groups a warp
constexpr int TREE_TOP = 128;  // nodes of the largest level tree_kernel takes
constexpr int TREE_THREADS = 32 * ((TREE_TOP / 2 + GROUPS - 1) / GROUPS);

// The schedule's constants, felts of 8 Montgomery words (the layout of
// kernels/poseidon254.schedule_table):
constexpr int TAB_RC = 0;        // the 8 full rounds' constants, 3 each
constexpr int TAB_POST = 24;     // added after round 3's S-boxes
constexpr int TAB_K = 27;        // each partial round's scalar
constexpr int TAB_MDS = 84;      // M, row-major
constexpr int TAB_PRE = 93;      // M_pre, round 3's matrix
constexpr int TAB_SPARSE = 102;  // each partial round's 3 lane rows
constexpr int TAB_FELTS = TAB_SPARSE + 9 * ROUNDS_PARTIAL;

using bn254::Fr;

__device__ uint32_t g_tab[TAB_FELTS * 8];

__device__ __forceinline__ void ld(uint32_t r[8], int felt) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = __ldg(g_tab + felt * 8 + k);
}

// x = x^5 (x may be a lazy sum below 2r; the result is canonical).
__device__ __forceinline__ void sbox(uint32_t x[8]) {
  uint32_t x2[8], x4[8];
  bn254::mul<Fr>(x2, x, x);
  bn254::mul<Fr>(x4, x2, x2);
  bn254::mul<Fr>(x, x4, x);
}

// r = row . (x0, x1, x2) for the 3-felt row at `felt`: one reduction.
__device__ __forceinline__ void dot3(uint32_t r[8], int felt,
                                     const uint32_t x0[8], const uint32_t x1[8],
                                     const uint32_t x2[8]) {
  uint32_t a[3][8], b[3][8];
  ld(a[0], felt);
  ld(a[1], felt + 1);
  ld(a[2], felt + 2);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    b[0][k] = x0[k];
    b[1][k] = x1[k];
    b[2][k] = x2[k];
  }
  bn254::mul_sum<Fr, 3>(r, a, b);
}

// ---------------------------------------------------------------------------
// one thread a hash
// ---------------------------------------------------------------------------

__device__ __forceinline__ void full_round1(uint32_t s[T][8], int r,
                                            int mat) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint32_t c[8];
    ld(c, TAB_RC + T * r + i);
    bn254::add_lazy(s[i], s[i], c);
    sbox(s[i]);
    if (mat == TAB_PRE) {
      ld(c, TAB_POST + i);
      bn254::add<Fr>(s[i], s[i], c);
    }
  }
  uint32_t out[T][8];
#pragma unroll
  for (int i = 0; i < T; ++i) dot3(out[i], mat + T * i, s[0], s[1], s[2]);
#pragma unroll
  for (int i = 0; i < T; ++i) bn254::copy(s[i], out[i]);
}

__device__ __forceinline__ void partial_round1(uint32_t s[T][8], int p) {
  uint32_t x[8], c[8], t[8];
  bn254::copy(x, s[0]);
  sbox(x);
  ld(c, TAB_K + p);
  bn254::add_lazy(x, x, c);
  const int row = TAB_SPARSE + 9 * p;
  dot3(s[0], row, x, s[1], s[2]);
#pragma unroll
  for (int i = 1; i < T; ++i) {
    ld(c, row + 3 * i);  // the first-column entry of lane row i
    bn254::mul<Fr>(t, c, x);
    bn254::add<Fr>(s[i], t, s[i]);
  }
}

// The full rounds r = 0 .. 7, the partial rounds between r = 3 and 4.
__device__ __forceinline__ void permute1(uint32_t s[T][8]) {
#pragma unroll 1
  for (int r = 0; r < 2 * ROUNDS_FULL_HALF; ++r) {
    if (r == ROUNDS_FULL_HALF) {
#pragma unroll 1
      for (int p = 0; p < ROUNDS_PARTIAL; ++p) partial_round1(s, p);
    }
    full_round1(s, r, r == ROUNDS_FULL_HALF - 1 ? TAB_PRE : TAB_MDS);
  }
}

// ---------------------------------------------------------------------------
// 3 lanes a hash: lane l = 0, 1, 2 of the group at `base` holds felt l
// ---------------------------------------------------------------------------

__device__ __forceinline__ void shfl8(uint32_t r[8], const uint32_t v[8],
                                      int src) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = __shfl_sync(0xffffffffu, v[k], src);
}

// Every lane of the warp must call it (shuffles); idle lanes pass l = 0
// and base = 0 and compute on what they read.
__device__ __forceinline__ void permute3(uint32_t own[8], int l, int base) {
  uint32_t c[8], x0[8], x1[8], x2[8];
#pragma unroll 1
  for (int r = 0; r < 2 * ROUNDS_FULL_HALF; ++r) {
    if (r == ROUNDS_FULL_HALF) {
#pragma unroll 1
      for (int p = 0; p < ROUNDS_PARTIAL; ++p) {
        uint32_t x[8];
        bn254::copy(x, own);
        sbox(x);
        ld(c, TAB_K + p);
        bn254::add_lazy(x, x, c);
        shfl8(x0, x, base);
        shfl8(x1, own, base + 1);
        shfl8(x2, own, base + 2);
        dot3(own, TAB_SPARSE + 9 * p + 3 * l, x0, x1, x2);
      }
    }
    ld(c, TAB_RC + T * r + l);
    bn254::add_lazy(own, own, c);
    sbox(own);
    const bool pre = r == ROUNDS_FULL_HALF - 1;
    if (pre) {
      ld(c, TAB_POST + l);
      bn254::add<Fr>(own, own, c);
    }
    shfl8(x0, own, base);
    shfl8(x1, own, base + 1);
    shfl8(x2, own, base + 2);
    dot3(own, (pre ? TAB_PRE : TAB_MDS) + T * l, x0, x1, x2);
  }
}

struct Lanes {
  int l, base, group;  // lane in its group, the group's first lane, group
  bool idle;           // lanes 30 and 31
};

__device__ __forceinline__ Lanes lanes_of(long long thread) {
  const int lane = (int)(thread & 31);
  Lanes g;
  g.idle = lane >= 3 * GROUPS;
  g.l = g.idle ? 0 : lane % 3;
  g.base = g.idle ? 0 : lane - g.l;
  g.group = lane / 3;
  return g;
}

// ---------------------------------------------------------------------------
// loads and stores
// ---------------------------------------------------------------------------

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

// A digest's 8 canonical words -> Montgomery form.
__device__ __forceinline__ void load_digest(uint32_t r[8], const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = w[k];
  bn254::to_mont<Fr>(r, r);
}

__device__ __forceinline__ void store_digest(uint32_t* out,
                                             const uint32_t s0[8]) {
  uint32_t d[8];
  bn254::from_mont<Fr>(d, s0);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = d[k];
}

__device__ __forceinline__ void zero(uint32_t r[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = 0;
}

__device__ __forceinline__ int felts_of(int cols) {
  return cols > 0 ? (cols + PACK - 1) / PACK : 1;
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    rows1_kernel(const uint32_t* __restrict__ in, long long n, int cols,
                 uint32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* x = in + row * cols;
  uint32_t s[T][8];
#pragma unroll
  for (int i = 0; i < T; ++i) zero(s[i]);
  const int blocks = (felts_of(cols) + 1) / 2;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t felt[8];
      pack_felt(x, cols, 2 * b + h, felt);
      bn254::add<Fr>(s[h], s[h], felt);
    }
    permute1(s);
  }
  store_digest(out + row * 8, s[0]);
}

__global__ void __launch_bounds__(THREADS)
    rows3_kernel(const uint32_t* __restrict__ in, long long n, int cols,
                 uint32_t* __restrict__ out) {
  const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Lanes g = lanes_of(thread);
  const long long row = (thread >> 5) * GROUPS + g.group;
  const bool live = !g.idle && row < n;
  uint32_t own[8];
  zero(own);
  const int blocks = (felts_of(cols) + 1) / 2;
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
    if (live && g.l < 2) {
      uint32_t felt[8];
      pack_felt(in + row * cols, cols, 2 * b + g.l, felt);
      bn254::add<Fr>(own, own, felt);
    }
    permute3(own, g.l, g.base);
  }
  if (live && g.l == 0) store_digest(out + row * 8, own);
}

// in: (m, 16) rows [left digest | right digest], canonical felt words.
__global__ void __launch_bounds__(THREADS)
    pairs1_kernel(const uint32_t* __restrict__ in, long long m,
                  uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t s[T][8];
  load_digest(s[0], in + i * 16);
  load_digest(s[1], in + i * 16 + 8);
  zero(s[2]);
  permute1(s);
  store_digest(out + i * 8, s[0]);
}

__global__ void __launch_bounds__(THREADS)
    pairs3_kernel(const uint32_t* __restrict__ in, long long m,
                  uint32_t* __restrict__ out) {
  const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Lanes g = lanes_of(thread);
  const long long i = (thread >> 5) * GROUPS + g.group;
  const bool live = !g.idle && i < m;
  uint32_t own[8];
  zero(own);
  if (live && g.l < 2) load_digest(own, in + i * 16 + 8 * g.l);
  permute3(own, g.l, g.base);
  if (live && g.l == 0) store_digest(out + i * 8, own);
}

// The levels above an (m, 8) level, m a power of two <= TREE_TOP, in one
// block: out holds them in order, (m/2 + m/4 + ... + 1, 8).
__global__ void __launch_bounds__(TREE_THREADS)
    tree_kernel(const uint32_t* __restrict__ level, int m,
                uint32_t* __restrict__ out) {
  __shared__ uint32_t buf[2][TREE_TOP * 8];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint32_t v[8];
    load_digest(v, level + 8 * i);
#pragma unroll
    for (int k = 0; k < 8; ++k) buf[0][8 * i + k] = v[k];
  }
  __syncthreads();
  const Lanes g = lanes_of(threadIdx.x);
  const int pair = (threadIdx.x >> 5) * GROUPS + g.group;
  int cur = 0, done = 0;
#pragma unroll 1
  for (int nodes = m; nodes > 1; nodes >>= 1) {
    const bool live = !g.idle && pair < nodes / 2;
    uint32_t own[8];
    zero(own);
    if (live && g.l < 2) {
#pragma unroll
      for (int k = 0; k < 8; ++k) own[k] = buf[cur][8 * (2 * pair + g.l) + k];
    }
    permute3(own, g.l, g.base);
    if (live && g.l == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) buf[cur ^ 1][8 * pair + k] = own[k];
      store_digest(out + 8 * (done + pair), own);
    }
    __syncthreads();
    cur ^= 1;
    done += nodes / 2;
  }
}

// Roots of q opened paths: leaf digests (q, 8), leaf indices (q), siblings
// (q, depth, 8), all canonical; out (q, 8).
__global__ void __launch_bounds__(THREADS)
    paths_kernel(const uint32_t* __restrict__ leaves,
                 const long long* __restrict__ index,
                 const uint32_t* __restrict__ sibs, long long q, int depth,
                 uint32_t* __restrict__ out) {
  const long long thread = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Lanes g = lanes_of(thread);
  const long long i = (thread >> 5) * GROUPS + g.group;
  const bool live = !g.idle && i < q;
  uint32_t node[8];
  zero(node);
  long long at = 0;
  if (live) {
    load_digest(node, leaves + 8 * i);
    at = index[i];
  }
#pragma unroll 1
  for (int d = 0; d < depth; ++d) {
    uint32_t own[8];
    zero(own);
    if (live && g.l < 2) {
      uint32_t sib[8];
      load_digest(sib, sibs + 8 * (i * depth + d));
      // lane 0 takes the left input, lane 1 the right one
      const bool node_left = ((at >> d) & 1) == 0;
      bn254::copy(own, (g.l == 0) == node_left ? node : sib);
    }
    permute3(own, g.l, g.base);
    shfl8(node, own, g.base);
  }
  if (live && g.l == 0) store_digest(out + 8 * i, node);
}

unsigned grid_of(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

// Threads of a 3-lane launch of n hashes: whole warps of GROUPS hashes.
long long lane_threads(long long n) { return 32 * ((n + GROUPS - 1) / GROUPS); }

}  // namespace

extern "C" {

// The words of the schedule's table (TAB_FELTS felts of 8 words).
int bt_p254_table_words() { return TAB_FELTS * 8; }

// Nodes of the largest level bt_p254_tree takes.
int bt_p254_tree_top() { return TREE_TOP; }

// Copies the schedule's constants (kernels/poseidon254.schedule_table) to
// the current device.
int bt_p254_set_constants(const uint32_t* table) {
  return (int)cudaMemcpyToSymbol(g_tab, table, sizeof(g_tab));
}

// Digests of the rows of a contiguous (n, cols) matrix of Montgomery Baby
// Bear words into a contiguous (n, 8) output, `lanes` (1 or 3) lanes a
// hash. Returns cudaGetLastError().
int bt_p254_rows(const uint32_t* in, long long n, int cols, int lanes,
                 uint32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 3) {
    rows3_kernel<<<grid_of(lane_threads(n)), THREADS, 0, s>>>(in, n, cols, out);
  } else if (lanes == 1) {
    rows1_kernel<<<grid_of(n), THREADS, 0, s>>>(in, n, cols, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Pair hashes of a contiguous (m, 16) input ([left | right] digest words)
// into a contiguous (m, 8) output. Returns cudaGetLastError().
int bt_p254_pairs(const uint32_t* in, long long m, int lanes, uint32_t* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes == 3) {
    pairs3_kernel<<<grid_of(lane_threads(m)), THREADS, 0, s>>>(in, m, out);
  } else if (lanes == 1) {
    pairs1_kernel<<<grid_of(m), THREADS, 0, s>>>(in, m, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Every level above an (m, 8) level (m a power of two, 2 <= m <=
// TREE_TOP) into out (m - 1, 8), lowest first, in one block.
int bt_p254_tree(const uint32_t* level, int m, uint32_t* out, void* stream) {
  if (m < 2 || m > TREE_TOP || (m & (m - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  tree_kernel<<<1, TREE_THREADS, 0, (cudaStream_t)stream>>>(level, m, out);
  return (int)cudaGetLastError();
}

// The roots of q opened paths of `depth` levels (leaves (q, 8), indices
// (q,) int64, siblings (q, depth, 8)) into out (q, 8).
int bt_p254_paths(const uint32_t* leaves, const long long* index,
                  const uint32_t* sibs, long long q, int depth, uint32_t* out,
                  void* stream) {
  paths_kernel<<<grid_of(lane_threads(q)), THREADS, 0, (cudaStream_t)stream>>>(
      leaves, index, sibs, q, depth, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
