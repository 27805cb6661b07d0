// The trace upload: canonical int64 words on the host -> Montgomery int32
// words on the card (Hopper, sm_90a).
//
// Replaces no TPU kernel. The JAX package converts a trace on the host
// (boundless_tpu/core/field.py mont_np, then an upload of the uint32
// words), and the port did the same in numpy (core/field.py fp): three
// whole int64 passes and an int32 cast over the witness's (2^20, 392) block
// before its copy, most of a po2-20 segment proof's time. Here the host
// copies the int64 words as they lie and the card converts them.
//
// The copy. The host array is a (rows, cols) block of int64 words with row
// pitch ld >= cols (the witness's 392 of 576 columns are read in place).
// bt_upload moves it in blocks of block_rows rows, each one 2-D copy (the
// block's cols words of each row, at the host's pitch) into one of two
// staging buffers on the card, rows packed at pitch cols: the witness moves
// 392 words a row, not 576. Copies run on a stream of their own,
// conversions on the caller's: block i + 1's copy overlaps block i's
// conversion, and a copy into a buffer waits for the conversion that last
// read it. The host does no gather and no arithmetic of its own. The copy
// stream is non-blocking, so a copy does not queue behind other work on
// the caller's stream, such as the cluster's other prove thread's kernels
// on the default stream. Two simpler designs were slower on an H100
// (PERF.md, PR 18): each block's whole byte range, with the pitch's unused
// words; and one buffer, copy and conversion in turn on the caller's
// stream.
//
// The conversion. A word x (any int64) becomes (x mod P) * 2^32 mod P, with
// numpy's floor mod (a negative x gives a value in [0, P)): the word
// core/field.py mont_np gives. x = hi * 2^32 + lo - [x < 0] 2^64, hi and lo
// its unsigned halves, so
//
//   x mod P = hi * 2^32 + (lo mod P) - [x < 0] (2^64 mod P)   (mod P),
//
// where hi * 2^32 mod P = bb::mul(hi, R^2) (R = 2^32: mul(a, b) is a b
// R^-1), lo < 3P takes two conditional subtracts, and 2^64 mod P = R^2.
// Then bb::mul(x mod P, R^2) = (x mod P) R. No 64-bit division.
//
// What bounds it on this card: the conversion reads 8 bytes and writes 4 a
// word (a po2-20 witness block, 2^20 x 392: 4.9 GB, ~1.5 ms at 3.35 TB/s);
// its threads walk the staging block with 8-byte loads on neighbouring
// addresses. The host-to-device copy from pageable memory, hundreds of times
// longer, bounds the upload.
#include <cuda_runtime.h>
#include <stdint.h>

#include "babybear.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_GRID = 1024;  // blocks of a launch: a full card
constexpr uint32_t R2 = 1172168163u;  // 2^64 mod P

// x mod P (floor) in Montgomery form, for any int64 x (see above).
__device__ __forceinline__ uint32_t mont_of(long long x) {
  const unsigned long long u = (unsigned long long)x;
  uint32_t lo = (uint32_t)u;
  lo = min(lo, lo - bb::P);
  lo = min(lo, lo - bb::P);
  uint32_t r = bb::add(bb::mul((uint32_t)(u >> 32), R2), lo);
  if (x < 0) r = bb::sub(r, R2);
  return bb::mul(r, R2);
}

// out[i] = mont_of(src[i]) for i < n: a staging block's words, rows
// packed, in a grid-stride loop of 8-byte loads on neighbouring addresses.
__global__ void __launch_bounds__(THREADS)
    upload_kernel(const long long* __restrict__ src,
                  uint32_t* __restrict__ out, long long n) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += step)
    out[i] = mont_of(src[i]);
}

int convert(const long long* src, uint32_t* out, long long n,
            cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  const unsigned grid = (unsigned)blocks;
  upload_kernel<<<grid, THREADS, 0, stream>>>(src, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The (rows, cols) int64 block at `host` (row pitch ld words) -> the
// contiguous (rows, cols) int32 `out` on the card, through the two staging
// buffers stage[0, stage_words) and stage[stage_words, 2 stage_words), in
// blocks of block_rows rows (block_rows * cols words must fit a buffer).
// *launches receives the conversions launched. Returns 0, the first
// failing call's CUDA error, or cudaErrorInvalidValue for sizes the
// pipeline does not take.
int bt_upload(const long long* host, long long rows, int cols, long long ld,
              long long block_rows, long long* stage, long long stage_words,
              uint32_t* out, void* stream, long long* launches) {
  *launches = 0;
  if (rows < 0 || cols < 0 || block_rows <= 0 ||
      (rows > 1 && ld < cols) || block_rows * cols > stage_words)
    return cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStream_t copy = nullptr;
  cudaEvent_t start = nullptr, ready[2] = {}, freed[2] = {};
  int rc = (int)cudaStreamCreateWithFlags(&copy, cudaStreamNonBlocking);
  if (!rc) rc = (int)cudaEventCreateWithFlags(&start, cudaEventDisableTiming);
  for (int b = 0; b < 2 && !rc; ++b) {
    rc = (int)cudaEventCreateWithFlags(&ready[b], cudaEventDisableTiming);
    if (!rc)
      rc = (int)cudaEventCreateWithFlags(&freed[b], cudaEventDisableTiming);
  }
  // the staging may be memory the caller's stream used last
  if (!rc) rc = (int)cudaEventRecord(start, s);
  if (!rc) rc = (int)cudaStreamWaitEvent(copy, start, 0);
  for (long long r0 = 0, i = 0; r0 < rows && !rc; r0 += block_rows, ++i) {
    const int b = (int)(i & 1);
    const long long n = rows - r0 < block_rows ? rows - r0 : block_rows;
    long long* buf = stage + b * stage_words;
    if (i >= 2) rc = (int)cudaStreamWaitEvent(copy, freed[b], 0);
    if (!rc)
      rc = (int)cudaMemcpy2DAsync(buf, (size_t)cols * 8, host + r0 * ld,
                                  (size_t)ld * 8, (size_t)cols * 8,
                                  (size_t)n, cudaMemcpyHostToDevice, copy);
    if (!rc) rc = (int)cudaEventRecord(ready[b], copy);
    if (!rc) rc = (int)cudaStreamWaitEvent(s, ready[b], 0);
    if (!rc) rc = convert(buf, out + r0 * cols, n * cols, s);
    if (!rc) {
      ++*launches;
      rc = (int)cudaEventRecord(freed[b], s);
    }
  }
  // the caller may release the host array on return, whatever memory
  // it lies in (a pageable one is read before a copy call returns)
  if (copy) {
    const int done = (int)cudaStreamSynchronize(copy);
    if (!rc) rc = done;
  }
  // released once their work is done
  for (int b = 0; b < 2; ++b) {
    if (ready[b]) cudaEventDestroy(ready[b]);
    if (freed[b]) cudaEventDestroy(freed[b]);
  }
  if (start) cudaEventDestroy(start);
  if (copy) cudaStreamDestroy(copy);
  return rc;
}

}  // extern "C"
