// Size-M NTT sub-transform over Baby Bear in shared memory (Hopper, sm_90a).
//
// Replaces the TPU Pallas kernel boundless_tpu/core/ntt_pallas.py
// _sub_ntt_kernel (:65), launched by _sub_ntt_call (:82) and driven by
// ntt_four_step (:142). For a row-major (m, lanes) uint32 Montgomery tile
// it runs the full radix-2 Stockham NTT of size m along axis 0 for every
// column, natural order in and out: stage t (s = 2^t) maps rows b and
// b + m/2 to rows 2*s*(b/s) + b%s and that + s, with the twiddle
// w_{2s}^(b%s) (the port's core/ntt.py stages, bit for bit).
//
// The four-step glue of the reference (the mid twiddle w_N^(k1*n2) and
// the transpose, plain XLA there) is folded into the store of the first
// launch of a level: with `mid` set, the (m, n2*inner) tile is stored as
// (n2, m*inner) with element (k1, j*inner + l) multiplied by mid[k1, j]
// and written to (j, k1*inner + l). One level of the four-step is then two
// launches, each one read and one write of the data.
//
// What bounds it on this card: at the main path's shapes (2^17..2^19 rows
// by 4..392 columns) one launch reads and writes the tensor once, and a
// radix-2 butterfly is a Montgomery product and two modular adds (~11
// integer instructions) per element pair per stage, so the m-point stages
// cost ~5.5*log2(m) instructions per word against 8 bytes moved: about
// the card's int32 ridge. The design keeps all log2(m) stages in shared
// memory (ping-pong buffers, the stage twiddles copied beside them) so a
// launch touches device memory once per word each way; a block owns a
// strip of W = 16 adjacent columns, so a warp's loads and stores are
// 64-byte runs of a row. M is limited by shared memory: two (M, 16)
// uint32 buffers plus M twiddles at M = 1024 take 132 KB of the 227 KB.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"

namespace {

constexpr int W = 16;         // columns per block
constexpr int THREADS = 256;  // 16 rows x 16 columns per pass
constexpr int MAX_LOG_M = 10;

__global__ void __launch_bounds__(THREADS)
sub_ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ tw, int log_m, unsigned lanes,
               const uint32_t* __restrict__ mid, unsigned inner,
               unsigned n2) {
  extern __shared__ uint32_t smem[];
  const int m = 1 << log_m;
  uint32_t* src = smem;
  uint32_t* dst = smem + m * W;
  uint32_t* stw = smem + 2 * m * W;
  const int col = threadIdx.x % W;
  const int r0 = threadIdx.x / W;
  constexpr int RSTEP = THREADS / W;
  const unsigned c = blockIdx.x * W + col;
  const bool live = c < lanes;

  for (int r = r0; r < m; r += RSTEP)
    src[r * W + col] = live ? in[(size_t)r * lanes + c] : 0u;
  for (int i = threadIdx.x; i < m; i += THREADS) stw[i] = tw[i];
  __syncthreads();

  const int half = m >> 1;
  for (int t = 0; t < log_m; ++t) {
    const int s = 1 << t;
    for (int b = r0; b < half; b += RSTEP) {
      const int j = b & (s - 1);
      const int o = ((b - j) << 1) + j;  // 2*s*(b/s) + b%s
      const uint32_t a = src[b * W + col];
      const uint32_t wb = bb::mul(src[(b + half) * W + col], stw[s + j]);
      dst[o * W + col] = bb::add(a, wb);
      dst[(o + s) * W + col] = bb::sub(a, wb);
    }
    __syncthreads();
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }

  if (!live) return;
  if (mid == nullptr) {
    for (int r = r0; r < m; r += RSTEP) out[(size_t)r * lanes + c] = src[r * W + col];
  } else {
    const unsigned jj = c / inner;
    const unsigned l = c - jj * inner;
    for (int r = r0; r < m; r += RSTEP)
      out[((size_t)jj * m + r) * inner + l] =
          bb::mul(src[r * W + col], mid[(size_t)r * n2 + jj]);
  }
}

}  // namespace

extern "C" {

// Largest sub-transform size the kernel takes (log2).
int bt_ntt_max_log_m() { return MAX_LOG_M; }

// Size-2^log_m NTT along axis 0 of a contiguous row-major (2^log_m, lanes)
// uint32 tile `in`, written to `out` (a distinct buffer). `tw` holds the
// 2^log_m stage twiddles (stage t at offset 2^t; word 0 unused). With
// `mid` non-null (a contiguous (2^log_m, n2) table, lanes = n2 * inner),
// the result is multiplied by mid[k1, j] and stored transposed as
// (n2, 2^log_m * inner). Returns cudaGetLastError() after the launch.
int bt_ntt_sub(const uint32_t* in, uint32_t* out, const uint32_t* tw,
               int log_m, unsigned lanes, const uint32_t* mid,
               unsigned inner, unsigned n2, void* stream) {
  if (log_m < 0 || log_m > MAX_LOG_M) return (int)cudaErrorInvalidValue;
  const size_t m = (size_t)1 << log_m;
  const size_t shmem = (2 * m * W + m) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      sub_ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (lanes + W - 1) / W;
  sub_ntt_kernel<<<blocks, THREADS, shmem, (cudaStream_t)stream>>>(
      in, out, tw, log_m, lanes, mid, inner, n2);
  return (int)cudaGetLastError();
}

}  // extern "C"
