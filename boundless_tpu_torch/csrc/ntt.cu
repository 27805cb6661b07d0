// Size-M NTT sub-transform over Baby Bear, radix passes in registers
// (Hopper, sm_90a).
//
// Replaces the TPU Pallas kernel boundless_tpu/core/ntt_pallas.py
// _sub_ntt_kernel (:65), launched by _sub_ntt_call (:82) and driven by
// ntt_four_step (:142). For a row-major (m, lanes) uint32 Montgomery tile
// it runs the size-m NTT along axis 0 for every column, natural order in
// and out (X_k = sum_n x_n w_m^(nk)). Field arithmetic is exact, so the
// words equal the port's radix-2 Stockham (core/ntt.py) bit for bit.
//
// Schedule: a mixed-radix Stockham. Each thread owns R = 32 elements of
// one column and runs one pass of radix R on them in registers (log2 R
// radix-2 stages, twiddles w_2s^j read with __ldg from one (m,) table of
// powers of w_m, the trivial w^0 products skipped); pass p (Ns = R^p)
// reads rows j + r*m/R, multiplies element r by w_(Ns R)^(r (j mod Ns))
// and writes rows (j / Ns) Ns R + j mod Ns + r Ns. Passes exchange
// through ONE shared (m, W) buffer: read, barrier, write, barrier. m =
// 1024 is two passes and one exchange (a radix-2 design makes ten shared
// round trips). A block owns W = 32 columns, so a warp's every global
// access is one whole 128-byte run of a row and every shared access hits
// 32 banks; for narrower strips (tools/ntt_variants.py builds them) the
// rows are swizzled (row ^ ((row >> log2 R) & (32/W - 1))) to keep the
// shared accesses so.
//
// Options of the one kernel (the glue passes of core/ntt.py, folded):
//   * four-step store (`mid`): the result is multiplied by mid[k1, j] and
//     stored transposed as (n2, m * inner); for inner < W dividing W the
//     strip's output is one contiguous run, staged through the buffer and
//     written linearly;
//   * load (`rows_in`, `load_a`, `load_b`): rows >= rows_in are zero and
//     are not read; element (row, c) is multiplied by load_a[row] *
//     load_b[c / inner] as it is loaded (the coset shift g^i of an LDE);
//   * store (`store_a`, `store_b`, `rows_out`): the result is multiplied by
//     store_a[row] * store_b[c / inner] (1/N and g^-k of an inverse) and
//     only rows < rows_out are stored.
//
// What bounds it on this card: a radix-2 butterfly is a product and two
// adds (12 instructions) per element pair per stage; at the main path's
// shapes a launch moves 8 bytes per element and does ~6 log2(m)
// instructions per element, both close to the card's int32 ridge, so the
// least time for one transform is the larger of the two (operations for
// 2^19 x 392). A four-step level is two launches (a transpose stands
// between the sub-transforms), so the design's own byte floor is twice
// one pass over the data: at 2^19 x 392 that floor (0.98 ms) is above the
// operation bound (0.70 ms), so the design is bound by its bytes. Each
// block loads, computes and stores in turn; only the other blocks on its
// SM overlap those phases. Occupancy: the data lives in registers between
// passes and the exchange buffer holds m * W words, so a block keeps
// W * m / R threads (1024 at m = 1024, which caps a thread at 64
// registers); the C entry bt_ntt_blocks_per_sm reports what fits on an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "babybear.cuh"

namespace {

constexpr int MAX_LOG_M = 10;
// The kernel's shape: R = 2^LOG_R elements a thread, W = 2^LOG_W columns
// a block (tools/ntt_variants.py builds copies with other values).
constexpr int LOG_R = 5;
constexpr int LOG_W = 5;

struct Args {
  const uint32_t* in;   // (rows_in, lanes)
  uint32_t* out;        // (rows_out, lanes), or (n2, m * inner) with mid
  const uint32_t* tw;   // (m,) powers of w_m (forward or inverse root)
  unsigned lanes, rows_in, rows_out;
  const uint32_t* mid;  // (m, n2) or null
  unsigned inner, n2;
  const uint32_t* load_a;   // (m,) or null
  const uint32_t* load_b;   // (lanes / inner,) or null
  const uint32_t* store_a;  // (m,) or null
  const uint32_t* store_b;  // (lanes / inner,) or null
  bool staged;  // the transposed store goes through xs (inner < W | W)
};

template <int LOG_M>
struct Cfg {
  static constexpr int M = 1 << LOG_M;
  static constexpr int LR = LOG_R < LOG_M ? LOG_R : LOG_M;
  static constexpr int R = 1 << LR;  // elements a thread owns
  static constexpr int W = 1 << LOG_W;
  static constexpr int J = M / R;  // threads per column
  static constexpr int T = W * J;  // threads per block
  static constexpr int NP = LOG_M == 0 ? 0 : (LOG_M + LR - 1) / LR;  // passes
  // rows one warp access spans (32 / W), capped at M
  static constexpr int K = (32 >> LOG_W) < M ? (32 >> LOG_W) : M;
  static __device__ __forceinline__ int phys(int row) {
    return K > 1 ? row ^ ((row >> LR) & (K - 1)) : row;
  }
};

// Natural-order radix-2 Stockham DFT of size 2^LRP on v[0 .. 2^LRP) in
// registers; stage t uses w_(2s)^jx = tw[jx << (LOG_M - t - 1)].
template <int LRP, int LOG_M>
__device__ __forceinline__ void dft(uint32_t* v, const uint32_t* __restrict__ tw) {
  constexpr int RP = 1 << LRP, H = RP / 2;
#pragma unroll
  for (int t = 0; t < LRP; ++t) {
    const int s = 1 << t;
    uint32_t u[RP];
#pragma unroll
    for (int b = 0; b < H; ++b) {
      const int jx = b & (s - 1);
      const int o = ((b - jx) << 1) + jx;
      const uint32_t hi = v[b + H];
      const uint32_t wb =
          jx == 0 ? hi : bb::mul(hi, __ldg(tw + (jx << (LOG_M - t - 1))));
      u[o] = bb::add(v[b], wb);
      u[o + s] = bb::sub(v[b], wb);
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) v[i] = u[i];
  }
}

// Pass P of the schedule on the thread's R registers. Pass 0's inputs were
// loaded already; later passes read the exchange buffer. All passes but
// the last write the buffer back.
template <class C, int LOG_M, int P>
__device__ __forceinline__ void pass(uint32_t* v, uint32_t* xs, int j, int col,
                                     const uint32_t* __restrict__ tw) {
  constexpr int LNS = P * C::LR;
  constexpr int LRP = (LOG_M - LNS) < C::LR ? (LOG_M - LNS) : C::LR;
  constexpr int RP = 1 << LRP, NS = 1 << LNS, G = C::R / RP;
  if constexpr (P > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jj = j + g * C::J;
#pragma unroll
      for (int r = 0; r < RP; ++r)
        v[g * RP + r] = xs[C::phys(jj + r * (C::M / RP)) * C::W + col];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jj = j + g * C::J;
      const int e = (jj & (NS - 1)) << (LOG_M - LNS - LRP);
#pragma unroll
      for (int r = 1; r < RP; ++r)
        v[g * RP + r] = bb::mul(v[g * RP + r], __ldg(tw + r * e));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) dft<LRP, LOG_M>(v + g * RP, tw);
  if constexpr (P + 1 < C::NP) {
    if constexpr (P > 0) __syncthreads();  // every read of this pass is done
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int jj = j + g * C::J;
      const int d = ((jj >> LNS) << (LNS + LRP)) + (jj & (NS - 1));
#pragma unroll
      for (int r = 0; r < RP; ++r)
        xs[C::phys(d + r * NS) * C::W + col] = v[g * RP + r];
    }
    __syncthreads();
    pass<C, LOG_M, P + 1>(v, xs, j, col, tw);
  }
}

template <int LOG_M>
__global__ void __launch_bounds__(Cfg<LOG_M>::T) sub_ntt_kernel(const Args a) {
  using C = Cfg<LOG_M>;
  extern __shared__ uint32_t xs[];  // (M, W) exchange buffer, rows swizzled
  const int col = threadIdx.x & (C::W - 1);
  const int j = threadIdx.x >> LOG_W;
  const unsigned c0 = blockIdx.x * C::W;
  const unsigned c = c0 + col;
  const bool live = c < a.lanes;
  const unsigned q = live ? c / a.inner : 0;  // column group (four-step j)

  uint32_t v[C::R];
  const uint32_t lb = (live && a.load_b) ? a.load_b[q] : 0u;
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    const unsigned row = j + r * C::J;
    uint32_t x = 0u;
    if (live && row < a.rows_in) {
      x = a.in[(size_t)row * a.lanes + c];
      if (a.load_a) {
        const uint32_t f = __ldg(a.load_a + row);
        x = bb::mul(x, a.load_b ? bb::mul(f, lb) : f);
      }
    }
    v[r] = x;
  }
  if constexpr (C::NP > 0) pass<C, LOG_M, 0>(v, xs, j, col, a.tw);

  // The last pass leaves element (g, r) at row jj + r * NS, jj = j + g * J.
  constexpr int LNS = (C::NP > 0 ? C::NP - 1 : 0) * C::LR;
  constexpr int RP = C::NP > 0 ? (1 << (LOG_M - LNS)) : 1;
  constexpr int NS = C::NP > 0 ? (1 << LNS) : 1;
  constexpr int G = C::R / RP;
  const uint32_t sb = (live && a.store_b) ? a.store_b[q] : 0u;
  if (a.staged && C::NP > 1) __syncthreads();  // the last pass read xs
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int row = j + g * C::J + r * NS;
      uint32_t y = v[g * RP + r];
      if (a.store_a) {
        const uint32_t f = __ldg(a.store_a + row);
        y = bb::mul(y, a.store_b ? bb::mul(f, sb) : f);
      }
      if (a.mid != nullptr && live)
        y = bb::mul(y, __ldg(a.mid + (size_t)row * a.n2 + q));
      if (a.staged) {
        xs[C::phys(row) * C::W + col] = y;
      } else if (live) {
        if (a.mid == nullptr) {
          if ((unsigned)row < a.rows_out) a.out[(size_t)row * a.lanes + c] = y;
        } else {
          const unsigned l = c - q * a.inner;
          a.out[((size_t)q * C::M + row) * a.inner + l] = y;
        }
      }
    }
  }
  if (a.staged) {
    // The strip's columns are whole groups of `inner`, so its output
    // (groups q0.., rows, l) is one contiguous run of M * width words.
    __syncthreads();
    const unsigned width = min((unsigned)C::W, a.lanes - c0);
    const int li = __ffs(a.inner) - 1;
    const unsigned total = width << LOG_M;
    for (unsigned i = threadIdx.x; i < total; i += C::T) {
      const unsigned gl = i >> (LOG_M + li);
      const unsigned rem = i - (gl << (LOG_M + li));
      const unsigned row = rem >> li;
      const unsigned cl = (gl << li) + (rem & (a.inner - 1));
      a.out[(size_t)c0 * C::M + i] = xs[C::phys(row) * C::W + cl];
    }
  }
}

using KernelFn = void (*)(const Args);

struct Table {
  KernelFn fn[MAX_LOG_M + 1];
  int threads[MAX_LOG_M + 1];
  template <int... L>
  Table(std::integer_sequence<int, L...>)
      : fn{sub_ntt_kernel<L>...}, threads{Cfg<L>::T...} {}
};

const Table& table() {
  static const Table t{std::make_integer_sequence<int, MAX_LOG_M + 1>{}};
  return t;
}

size_t shmem_bytes(int log_m) {
  return ((size_t)1 << (log_m + LOG_W)) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Largest sub-transform size the kernel takes (log2).
int bt_ntt_max_log_m() { return MAX_LOG_M; }

// Blocks of the size-2^log_m kernel that fit on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
int bt_ntt_blocks_per_sm(int log_m) {
  if (log_m < 0 || log_m > MAX_LOG_M) return -(int)cudaErrorInvalidValue;
  const KernelFn fn = table().fn[log_m];
  const size_t shmem = shmem_bytes(log_m);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, table().threads[log_m], shmem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// Size-2^log_m NTT along axis 0 of the (2^log_m, lanes) tile whose first
// rows_in rows are the contiguous row-major `in` (the rest zero), written
// to `out` (a distinct buffer): see the options above. `tw` holds the
// 2^log_m powers of the size-2^log_m root of the direction. Returns
// cudaGetLastError() after the launch.
int bt_ntt_sub(const uint32_t* in, uint32_t* out, const uint32_t* tw,
               int log_m, unsigned lanes, unsigned rows_in, unsigned rows_out,
               const uint32_t* mid, unsigned inner, unsigned n2,
               const uint32_t* load_a, const uint32_t* load_b,
               const uint32_t* store_a, const uint32_t* store_b,
               void* stream) {
  if (log_m < 0 || log_m > MAX_LOG_M || inner == 0)
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = table().fn[log_m];
  const size_t shmem = shmem_bytes(log_m);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned w = 1u << LOG_W;
  const bool staged = mid != nullptr && inner < w && w % inner == 0;
  const unsigned blocks = (lanes + w - 1) / w;
  const Args a{in,    out,   tw,     lanes,  rows_in, rows_out, mid,
               inner, n2,    load_a, load_b, store_a, store_b,  staged};
  fn<<<blocks, table().threads[log_m], shmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
