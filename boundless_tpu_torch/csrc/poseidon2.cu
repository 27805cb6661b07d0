// Poseidon2 sponge over Baby Bear (Hopper, sm_90a): one hash a thread, or
// one hash spread over a group of 2, 4 or 8 lanes of a warp; and a Merkle
// tree's top levels in one block.
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
// whole state. The tree kernel is the level loop of the reference's
// merkle.commit above a level of at most TREE_MAX nodes.
//
// What bounds it on this card. Throughput: integer ALU work. Every 16
// input words cost one permutation, about 29 rounds of S-boxes (4
// Montgomery products each; 24 per external round, 1 per internal round)
// plus the linear layers (the 14-add M4 sequence and the chunk sums; 24
// diagonal products and a 24-term sum per internal round): roughly 1,400
// 32x32->64 products per block, against 4 bytes read per input word, far
// above the H100's ops:byte ridge. Latency: the permutations of one hash
// are a dependent chain (253 of them for a 4,048-column row, 2,056 for a
// KeccakAir proof's DEEP absorb), each round waits on the one before, and
// inside a round the S-box is four dependent products and the internal
// sum a 24-term tree. A launch with few rows puts too few warps on a
// scheduler to hide that latency: at one thread a hash, 2,048 rows are 64
// warps on 132 SMs, and a transcript permutation (N = 1) is one thread
// issuing alone, so such launches run at the chain's latency and not at
// the card's issue rate.
//
// What the design does about it. A thread keeps its share of the state in
// registers for the whole sponge (no shared memory or device memory
// between rounds), and a product is one native wide multiply plus a
// Montgomery reduction (csrc/babybear.cuh). Launches with many rows keep one thread a
// hash (K = 6 chunks a thread; the constants in __constant__ memory, where
// a warp reads one word at a time, a broadcast). Launches with few rows
// split each hash's 24-word state into whole M4 chunks over a group of
// G = 2, 4 or 8 lanes of one warp: K = 3, 2 or 1 chunks a lane, 6 / K
// lanes active and G - 6 / K idle. M4, the S-boxes and the diagonal
// products stay in the lane's registers; only the external layer's four
// chunk sums and the internal layer's sum cross lanes, as log2(G)
// __shfl_xor_sync butterfly steps inside the group (an idle lane adds
// zero). The internal rounds take that sum off their chain
// (internal_rounds_split): every lane runs word 0's scalar chain, and the
// sum of the other 23 words for round r + 1 is the group sum of round r's
// diagonal products, started before round r's S-box, plus 23 S_r. A lane
// so issues 1/2 to 1/6 of a round's instructions, the card gets G times
// the warps, and an internal round's chain is its S-box and three adds. A
// lane's round constants and mu differ across the group, so it reads them
// from the block's copy in shared memory and from registers (divergent
// __constant__ reads serialise). Each lane loads its rate chunks of a
// block as 16-byte loads where the row is 16-byte aligned. The wrapper
// (kernels/poseidon2.py) picks G from N. A tree's top levels are one
// launch of one block: the level is copied into shared memory, each level
// above is hashed from there with G chosen per level to fill the block, a
// __syncthreads() between levels, and every level is written to device
// memory as well. Round loops stay rolled: nvcc 12.9's front end (cicc)
// crashes when all 29 rounds are unrolled into one body.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"

namespace {

constexpr int WIDTH = 24;
constexpr int RATE = 16;
constexpr int DIGEST = 8;
constexpr int ROUNDS_HALF = 4;
constexpr int ROUNDS_PARTIAL = 21;
constexpr int EXT_RC = 2 * ROUNDS_HALF * WIDTH;
constexpr int SPONGE_THREADS = 128;
constexpr int TREE_THREADS = 512;
constexpr int TREE_MAX = 4096;  // nodes of the largest level a tree top takes

__constant__ uint32_t c_ext_rc[EXT_RC];
__constant__ uint32_t c_int_rc[ROUNDS_PARTIAL];
__constant__ uint32_t c_mu[WIDTH];

// K whole M4 chunks a lane: WORDS state words, ACTIVE lanes a hash in a
// group of GROUP lanes (a power of two, so groups never straddle a warp).
template <int K>
struct Layout {
  static_assert(K == 6 || K == 3 || K == 2 || K == 1, "whole chunks");
  static constexpr int WORDS = 4 * K;
  static constexpr int ACTIVE = 6 / K;
  static constexpr int GROUP = K == 6 ? 1 : K == 3 ? 2 : K == 2 ? 4 : 8;
};

// One lane's place in its group: lane g holds state words base ..
// base + WORDS - 1 (chunks g*K .. g*K + K - 1) if g < ACTIVE.
template <int K>
struct Lane {
  int g;
  int base;     // first state word held (0 for an idle lane)
  bool active;  // holds state words
  const uint32_t* ext;  // the block's shared copy of c_ext_rc (K < 6)
  uint32_t mu[K == 6 ? 1 : 4 * K];

  __device__ __forceinline__ Lane(int lane, const uint32_t* shared_ext)
      : g(lane), ext(shared_ext) {
    active = lane < Layout<K>::ACTIVE;
    base = active ? lane * Layout<K>::WORDS : 0;
    if constexpr (K < 6) {
#pragma unroll
      for (int j = 0; j < Layout<K>::WORDS; ++j) mu[j] = c_mu[base + j];
    }
  }
  __device__ __forceinline__ uint32_t ext_rc(int r, int j) const {
    if constexpr (K == 6) return c_ext_rc[r * WIDTH + j];
    else return ext[r * WIDTH + base + j];
  }
};

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

// Sum of the N words s[0], s[STRIDE], ..., as a balanced tree.
template <int N, int STRIDE>
__device__ __forceinline__ uint32_t tree_sum(const uint32_t* s) {
  if constexpr (N == 1) {
    return s[0];
  } else {
    constexpr int H = N / 2;
    return bb::add(tree_sum<H, STRIDE>(s),
               tree_sum<N - H, STRIDE>(s + H * STRIDE));
  }
}

// The sum of a value over the lanes of a group (every lane gets it); an
// idle lane adds zero. Butterfly partners are lane ^ 1, lane ^ 2, ...
template <int K>
__device__ __forceinline__ uint32_t group_sum(uint32_t v, bool active) {
  constexpr int G = Layout<K>::GROUP;
  if constexpr (Layout<K>::ACTIVE < G) v = active ? v : 0u;
#pragma unroll
  for (int o = 1; o < G; o <<= 1)
    v = bb::add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// M_E = circ(2*M4, M4, ..., M4): M4 on each 4-chunk, plus the chunk sum.
template <int K>
__device__ __forceinline__ void external_linear(uint32_t* s,
                                                const Lane<K>& lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) m4(s + 4 * k);
  uint32_t t[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    t[c] = group_sum<K>(tree_sum<K, 4>(s + c), lane.active);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[4 * k + c] = bb::add(s[4 * k + c], t[c]);
}

template <int K>
__device__ __forceinline__ void external_round(uint32_t* s, int r,
                                               const Lane<K>& lane) {
#pragma unroll
  for (int j = 0; j < 4 * K; ++j) s[j] = sbox(bb::add(s[j], lane.ext_rc(r, j)));
  external_linear<K>(s, lane);
}

// M_I = J + diag(mu): s_j <- mu_j * s_j + sum(s), after the S-box on
// word 0 (one thread a hash; the S-box's result joins the sum last).
__device__ __forceinline__ void internal_round(uint32_t* s, int r) {
  const uint32_t x0 = sbox(bb::add(s[0], c_int_rc[r]));
  const uint32_t sum = bb::add(tree_sum<WIDTH - 1, 1>(s + 1), x0);
  s[0] = x0;
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = bb::add(bb::mul(s[j], c_mu[j]), sum);
}

// The 21 internal rounds of a lane group (K < 6), with the group sum off
// the rounds' chain. Round r maps v -> v': x = v but x_0 = sbox(v_0 +
// rc_r), S_r = x_0 + L_r with L_r = sum_{j>0} v_j, and v'_j = mu_j x_j +
// S_r. For j > 0, v_j(r) = m_j(r-1) + S_{r-1} with m_j = mu_j v_j, so
// L_r = M_{r-1} + 23 S_{r-1}, M_{r-1} = sum_{j>0} m_j(r-1): the group sum
// of round r-1's products, which round r-1 computes anyway and starts
// summing across the group before its own S-box. Every lane runs word 0's
// scalar chain (v_0, x_0, S); the lane that holds word 0 takes v_0 at the
// end. The chain is then the S-box and three adds a round.
template <int K>
__device__ __forceinline__ void internal_rounds_split(uint32_t* s,
                                                      const Lane<K>& lane) {
  constexpr int W = 4 * K;
  constexpr int G = Layout<K>::GROUP;
  constexpr uint32_t C23 = (uint32_t)((23ull << 32) % bb::P);  // Montgomery
  const bool lead = lane.g == 0;  // holds word 0 in slot 0
  const uint32_t mu0 = c_mu[0];
  uint32_t v0 = __shfl_sync(0xffffffffu, s[0], (threadIdx.x & 31) & ~(G - 1));
  uint32_t l = group_sum<K>(
      bb::add(lead ? 0u : s[0], tree_sum<W - 1, 1>(s + 1)),
      lane.active);  // L_0
#pragma unroll 1
  for (int r = 0; r < ROUNDS_PARTIAL; ++r) {
    uint32_t m[W];
#pragma unroll
    for (int j = 0; j < W; ++j) m[j] = bb::mul(lane.mu[j], s[j]);
    const uint32_t m_sum = group_sum<K>(
        bb::add(lead ? 0u : m[0], tree_sum<W - 1, 1>(m + 1)), lane.active);
    const uint32_t x0 = sbox(bb::add(v0, c_int_rc[r]));
    const uint32_t sum = bb::add(x0, l);  // S_r
    v0 = bb::add(bb::mul(mu0, x0), sum);
#pragma unroll
    for (int j = 0; j < W; ++j) s[j] = bb::add(m[j], sum);
    l = bb::add(m_sum, bb::mul(C23, sum));  // L_{r+1}
  }
  if (lead) s[0] = v0;
}

template <int K>
__device__ __forceinline__ void permute(uint32_t* s, const Lane<K>& lane) {
  external_linear<K>(s, lane);
#pragma unroll 1
  for (int r = 0; r < ROUNDS_HALF; ++r) external_round<K>(s, r, lane);
  if constexpr (K == 6) {
#pragma unroll 1
    for (int r = 0; r < ROUNDS_PARTIAL; ++r) internal_round(s, r);
  } else {
    internal_rounds_split<K>(s, lane);
  }
#pragma unroll 1
  for (int r = ROUNDS_HALF; r < 2 * ROUNDS_HALF; ++r)
    external_round<K>(s, r, lane);
}

// Adds the lane's rate chunks of the block at column c0 (chunk q < 4 is
// words c0 + 4q .. c0 + 4q + 3; words past `cols` are the zero padding).
template <int K>
__device__ __forceinline__ void absorb(uint32_t* s, const uint32_t* row,
                                       int c0, int cols, bool vec4, int g) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = g * K + k;
    if (q >= RATE / 4) continue;
    const int w0 = c0 + 4 * q;
    uint32_t* x = s + 4 * k;
    if (vec4 && w0 + 4 <= cols) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + w0));
      x[0] = bb::add(x[0], v.x);
      x[1] = bb::add(x[1], v.y);
      x[2] = bb::add(x[2], v.z);
      x[3] = bb::add(x[3], v.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (w0 + c < cols) x[c] = bb::add(x[c], __ldg(row + w0 + c));
    }
  }
}

// One hash a group of GROUP lanes: thread t is lane t % GROUP of hash
// t / GROUP. A warp with no hash of its own returns; a warp's lanes past
// the last hash run along (zero state) for the shuffles.
template <int K>
__global__ void __launch_bounds__(SPONGE_THREADS)
sponge_kernel(const uint32_t* __restrict__ in, long long n, int cols,
              int vec4, const uint32_t* __restrict__ init,
              uint32_t* __restrict__ out, int out_words) {
  constexpr int G = Layout<K>::GROUP;
  constexpr int W = Layout<K>::WORDS;
  __shared__ uint32_t s_ext[K == 6 ? 1 : EXT_RC];
  if constexpr (K < 6) {
    for (int j = threadIdx.x; j < EXT_RC; j += blockDim.x) s_ext[j] = c_ext_rc[j];
    __syncthreads();
  }
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t / G;
  if ((t & ~31LL) / G >= n) return;
  const bool valid = i < n;
  const Lane<K> lane((int)(t % G), s_ext);
  const bool own = valid && lane.active;
  uint32_t s[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    s[j] = (init != nullptr && own) ? init[i * WIDTH + lane.base + j] : 0u;
  const uint32_t* row = in + (valid ? i : 0) * (long long)cols;
  const int blocks = cols > 0 ? (cols + RATE - 1) / RATE : 1;
  for (int b = 0; b < blocks; ++b) {
    if (own) absorb<K>(s, row, b * RATE, cols, vec4 != 0, lane.g);
    permute<K>(s, lane);
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (own && lane.base + j < out_words) out[i * out_words + lane.base + j] = s[j];
}

// Lanes a hash for a tree level of h hashes in one block: the most that
// still fit the block in one pass, else one.
__device__ __forceinline__ int tree_lanes(int h) {
  for (int lanes = 8; lanes > 1; lanes >>= 1)
    if (h * lanes <= TREE_THREADS) return lanes;
  return 1;
}

// Hashes the h pairs of `src` (node 2i, 2i+1 -> 16 words at 16i) into
// `dst` and `gdst` (node i at 8i), TREE_THREADS / GROUP hashes a pass; a
// warp whose first hash of the pass is past h stops.
template <int K>
__device__ __forceinline__ void tree_level(const uint32_t* src, uint32_t* dst,
                                           uint32_t* __restrict__ gdst, int h,
                                           const uint32_t* s_ext) {
  constexpr int G = Layout<K>::GROUP;
  constexpr int W = Layout<K>::WORDS;
  const Lane<K> lane(threadIdx.x % G, s_ext);
  const int slot = threadIdx.x / G;
  const int warp_slot = (threadIdx.x & ~31) / G;
  for (int first = 0; first < h; first += TREE_THREADS / G) {
    if (first + warp_slot >= h) break;
    const int i = first + slot;
    const bool own = i < h && lane.active;
    uint32_t s[W];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane.g * K + k;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[4 * k + c] = (own && q < RATE / 4) ? src[16 * i + 4 * q + c] : 0u;
    }
    permute<K>(s, lane);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int w = lane.base + j;
      if (own && w < DIGEST) {
        dst[DIGEST * i + w] = s[j];
        gdst[DIGEST * i + w] = s[j];
      }
    }
  }
}

// One block: level (m, 8), m a power of two in [2, TREE_MAX] -> out
// ((m - 1), 8), the levels of m/2, m/4, ..., 1 nodes one after another.
// Shared memory: the constants, then buffers of m and m/2 nodes used in
// turn as source and destination.
__global__ void __launch_bounds__(TREE_THREADS)
tree_kernel(const uint32_t* __restrict__ level, int m,
            uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_ext = smem;
  uint32_t* a = smem + EXT_RC;
  uint32_t* b = a + m * DIGEST;
  for (int j = threadIdx.x; j < EXT_RC; j += blockDim.x) s_ext[j] = c_ext_rc[j];
  for (int j = threadIdx.x; j < m * DIGEST; j += blockDim.x) a[j] = level[j];
  __syncthreads();
  for (int h = m / 2; h >= 1; h >>= 1) {
    switch (tree_lanes(h)) {
      case 8: tree_level<1>(a, b, out, h, s_ext); break;
      case 4: tree_level<2>(a, b, out, h, s_ext); break;
      case 2: tree_level<3>(a, b, out, h, s_ext); break;
      default: tree_level<6>(a, b, out, h, s_ext); break;
    }
    __syncthreads();
    out += h * DIGEST;
    uint32_t* tmp = a;
    a = b;
    b = tmp;
  }
}

template <int K>
cudaError_t launch_sponge(const uint32_t* in, long long n, int cols, int vec4,
                          const uint32_t* init, uint32_t* out, int out_words,
                          cudaStream_t stream) {
  const long long threads = n * Layout<K>::GROUP;
  const long long blocks = (threads + SPONGE_THREADS - 1) / SPONGE_THREADS;
  sponge_kernel<K><<<(unsigned)blocks, SPONGE_THREADS, 0, stream>>>(
      in, n, cols, vec4, init, out, out_words);
  return cudaGetLastError();
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

// The largest level (nodes) the tree kernel takes.
int bt_p2_tree_max() { return TREE_MAX; }

// Sponge over the rows of a contiguous row-major (n, cols) input, `lanes`
// (1, 2, 4 or 8) lanes a hash; writes the first out_words state words of
// each row to a contiguous (n, out_words) output. `init` is null or a
// contiguous (n, 24) state. `vec4`: rows are 16-byte aligned (cols % 4 ==
// 0 and a 16-byte aligned base). Returns cudaGetLastError() after the
// launch (0 on success).
int bt_p2_sponge(const uint32_t* in, long long n, int cols, int vec4,
                 const uint32_t* init, uint32_t* out, int out_words, int lanes,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return (int)launch_sponge<6>(in, n, cols, vec4, init, out, out_words, st);
    case 2: return (int)launch_sponge<3>(in, n, cols, vec4, init, out, out_words, st);
    case 4: return (int)launch_sponge<2>(in, n, cols, vec4, init, out, out_words, st);
    case 8: return (int)launch_sponge<1>(in, n, cols, vec4, init, out, out_words, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The levels above a contiguous (m, 8) digest level in one block (m a
// power of two in [2, TREE_MAX]) into a contiguous (m - 1, 8) output.
int bt_p2_tree(const uint32_t* level, int m, uint32_t* out, void* stream) {
  if (m < 2 || m > TREE_MAX || (m & (m - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (EXT_RC + 3 * (m / 2) * DIGEST) * (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {  // past the default limit of dynamic shared memory
    cudaError_t e = cudaFuncSetAttribute(
        tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  tree_kernel<<<1, TREE_THREADS, smem, (cudaStream_t)stream>>>(level, m, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
