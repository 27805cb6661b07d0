// BN254 G1 multi-scalar multiplication (Pippenger, 8-bit signed windows)
// on Hopper (sm_90a).
//
// Replaces the TPU-shaped XLA MSM of boundless_tpu/groth16/msm_tpu.py:
// msm_pippenger (:237) and its device half _pip_device (:187), which sum
// each (window, digit) bucket by a segmented associative scan of ec_add
// (:92, branchless Jacobian addition on 13-bit x 20 limbs), reduce every
// window's buckets by a suffix scan and _tree_reduce_axis1 (:218), and
// join the windows with ec_double (:71). It computes the same function,
// sum_i s_i * P_i over G1, with another schedule.
//
// Inputs (prepared by groth16/msm_device.py in torch): each scalar is
// recoded into 32 signed 8-bit digits d in [-127, 128] (sum_w d_w 2^(8w)
// = s; r < 0x31 * 2^248, so window 31 never carries out); an entry is a
// nonzero digit, kept in bucket window * 128 + |d| - 1, with its point's
// index, bitwise negated (~i < 0) where d < 0. Entries are sorted by
// bucket and each bucket's list is cut into chunks:
//   points  (n, 16) u32: affine x, y in Montgomery form (R = 2^256,
//           csrc/bn254_field.cuh), (0, 0) for the point at infinity;
//   idx     (E,) the signed point index of each sorted entry;
//   chunk_start, chunk_len (C,): each chunk's entries;
//   bucket_chunk0, bucket_chunks (4096,): each bucket's chunks.
// Four launches:
//   1. chunk_kernel: one thread a chunk sums its points (y negated for a
//      negative digit, q - y) into a Jacobian partial, by mixed additions;
//   2. bucket_kernel: one thread a bucket sums its chunks' partials;
//   3. slice_kernel: the bit slices of every window, S_(w,b) = the sum of
//      the buckets whose |d| has bit b set (64 buckets for b < 7, the one
//      of d = 128 for b = 7), so that sum_d d B_d = sum_b 2^b S_(w,b): 8
//      lanes a slice add 8 buckets each, then 3 butterfly steps by
//      __shfl_xor_sync;
//   4. window_kernel: one block of 32 threads: thread w forms window w's
//      sum, S_(w,7) doubled and added down to S_(w,0) (7 doublings);
//      thread 0 then joins the windows, most significant first, with 8
//      doublings and one addition each.
// Points are Jacobian (X, Y, Z), Z = 0 at infinity; the additions handle
// infinity, doubling (P + P) and negation (P + -P) exactly, with branches
// (a bucket may hold P and -P now). Every value a comparison reads is
// canonical.
//
// What bounds it on this card: the 32-bit multiply-adds of its field
// products. A mixed addition is 11 Montgomery products, a Jacobian one 16,
// a doubling 7; each product is 64 32x32->64 products and a reduction. At
// n points that is about 32 n mixed additions, against 64 bytes read a
// point: bound by operations, not bytes. Latency: the passes after the
// chunks are chains on few threads, a fixed tail whatever n. A window's
// sum by a running suffix sum would be 2 x 255 dependent additions on one
// thread; here the longest chain after the bucket pass is a slice's 11
// additions, a window's 7 doublings and 7 additions, and the join's 248
// doublings and 31 additions. The signed
// digits halve the buckets (the bucket pass's threads add twice the
// chunks) and the wrapper's chunk length grows with n (msm_device.prep),
// so that a bucket's chain stays short. The curve functions that a pass
// calls from several places (jac_add, jac_double) are one copy each; the
// chunk pass's mixed addition is inlined.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_field.cuh"

namespace {

using bn254::Fq;

constexpr int WINDOWS = 32;
constexpr int BUCKETS = 128;  // |d| = 1 .. 128
constexpr int WINDOW_BITS = 8;
constexpr int SLICE_LANES = 8;  // lanes a bit slice
constexpr int SLICE_MEMBERS = 64;  // buckets of a slice for b < 7
constexpr int THREADS = 128;

struct Jac {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void set_inf(Jac& p) {
#pragma unroll
  for (int k = 0; k < 8; ++k) p.x[k] = p.y[k] = p.z[k] = 0;
}

__device__ __forceinline__ bool is_inf(const Jac& p) {
  return bn254::is_zero(p.z);
}

__device__ __forceinline__ void fq_mont_one(uint32_t r[8]) {
  uint32_t one[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) one[k] = k == 0;
  bn254::to_mont<Fq>(r, one);
}

// p = 2p (dbl-2009-l, a = 0; bn254.G1.double). No point of G1 has Y = 0.
__device__ __noinline__ void jac_double(Jac& p) {
  if (is_inf(p)) return;
  uint32_t a[8], b[8], c[8], d[8], e[8], f[8], t[8];
  bn254::mul<Fq>(a, p.x, p.x);
  bn254::mul<Fq>(b, p.y, p.y);
  bn254::mul<Fq>(c, b, b);
  bn254::add<Fq>(t, p.x, b);
  bn254::mul<Fq>(d, t, t);
  bn254::sub<Fq>(d, d, a);
  bn254::sub<Fq>(d, d, c);
  bn254::add<Fq>(d, d, d);  // D = 2((X + B)^2 - A - C)
  bn254::add<Fq>(e, a, a);
  bn254::add<Fq>(e, e, a);  // E = 3A
  bn254::mul<Fq>(f, e, e);
  // Z3 = 2 Y Z (before Y is overwritten)
  bn254::mul<Fq>(t, p.y, p.z);
  bn254::add<Fq>(p.z, t, t);
  bn254::add<Fq>(t, d, d);
  bn254::sub<Fq>(p.x, f, t);  // X3 = F - 2D
  bn254::sub<Fq>(t, d, p.x);
  bn254::mul<Fq>(t, e, t);
  bn254::add<Fq>(c, c, c);
  bn254::add<Fq>(c, c, c);
  bn254::add<Fq>(c, c, c);  // 8C
  bn254::sub<Fq>(p.y, t, c);  // Y3 = E (D - X3) - 8C
}

// The addition's common tail once U1, U2, S1, S2 are known (H != 0):
// X3 = r^2 - J - 2V, Y3 = r (V - X3) - 2 S1 J, with H = U2 - U1,
// I = 4 H^2, J = H I, r = 2 (S2 - S1), V = U1 I; returns H for Z3.
__device__ __forceinline__ void add_tail(Jac& out, const uint32_t u1[8],
                                         const uint32_t s1[8],
                                         const uint32_t h[8],
                                         const uint32_t s2[8]) {
  uint32_t i[8], j[8], r[8], v[8], t[8];
  bn254::add<Fq>(t, h, h);
  bn254::mul<Fq>(i, t, t);  // I = (2H)^2
  bn254::mul<Fq>(j, h, i);
  bn254::sub<Fq>(r, s2, s1);
  bn254::add<Fq>(r, r, r);
  bn254::mul<Fq>(v, u1, i);
  bn254::mul<Fq>(t, r, r);
  bn254::sub<Fq>(t, t, j);
  bn254::sub<Fq>(t, t, v);
  bn254::sub<Fq>(out.x, t, v);
  bn254::sub<Fq>(t, v, out.x);
  bn254::mul<Fq>(t, r, t);
  bn254::mul<Fq>(j, s1, j);
  bn254::add<Fq>(j, j, j);
  bn254::sub<Fq>(out.y, t, j);
}

// p += q (Jacobian + Jacobian; bn254.G1.add).
__device__ __noinline__ void jac_add(Jac& p, const Jac& q) {
  if (is_inf(q)) return;
  if (is_inf(p)) {
    p = q;
    return;
  }
  uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], h[8], t[8];
  bn254::mul<Fq>(z1z1, p.z, p.z);
  bn254::mul<Fq>(z2z2, q.z, q.z);
  bn254::mul<Fq>(u1, p.x, z2z2);
  bn254::mul<Fq>(u2, q.x, z1z1);
  bn254::mul<Fq>(t, p.y, q.z);
  bn254::mul<Fq>(s1, t, z2z2);
  bn254::mul<Fq>(t, q.y, p.z);
  bn254::mul<Fq>(s2, t, z1z1);
  if (bn254::eq(u1, u2)) {
    if (bn254::eq(s1, s2)) {
      jac_double(p);
    } else {
      set_inf(p);
    }
    return;
  }
  bn254::sub<Fq>(h, u2, u1);
  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  bn254::add<Fq>(t, p.z, q.z);
  bn254::mul<Fq>(t, t, t);
  bn254::sub<Fq>(t, t, z1z1);
  bn254::sub<Fq>(t, t, z2z2);
  bn254::mul<Fq>(p.z, t, h);
  add_tail(p, u1, s1, h, s2);
}

// p += (x2, y2), an affine point ((0, 0) is infinity): Z2 = 1.
__device__ __forceinline__ void jac_add_affine(Jac& p, const uint32_t x2[8],
                               const uint32_t y2[8]) {
  if (bn254::is_zero(x2) && bn254::is_zero(y2)) return;
  if (is_inf(p)) {
    bn254::copy(p.x, x2);
    bn254::copy(p.y, y2);
    fq_mont_one(p.z);
    return;
  }
  uint32_t z1z1[8], u1[8], u2[8], s1[8], s2[8], h[8], t[8];
  bn254::mul<Fq>(z1z1, p.z, p.z);
  bn254::copy(u1, p.x);
  bn254::mul<Fq>(u2, x2, z1z1);
  bn254::copy(s1, p.y);
  bn254::mul<Fq>(t, y2, p.z);
  bn254::mul<Fq>(s2, t, z1z1);
  if (bn254::eq(u1, u2)) {
    if (bn254::eq(s1, s2)) {
      jac_double(p);
    } else {
      set_inf(p);
    }
    return;
  }
  bn254::sub<Fq>(h, u2, u1);
  bn254::mul<Fq>(t, p.z, h);
  bn254::add<Fq>(p.z, t, t);  // Z3 = 2 Z1 H
  add_tail(p, u1, s1, h, s2);
}

__device__ __forceinline__ void load_jac(Jac& p, const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    p.x[k] = w[k];
    p.y[k] = w[8 + k];
    p.z[k] = w[16 + k];
  }
}

__device__ __forceinline__ void store_jac(uint32_t* w, const Jac& p) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = p.x[k];
    w[8 + k] = p.y[k];
    w[16 + k] = p.z[k];
  }
}

__global__ void __launch_bounds__(THREADS)
    chunk_kernel(const uint32_t* __restrict__ points,
                 const int* __restrict__ idx,
                 const long long* __restrict__ chunk_start,
                 const int* __restrict__ chunk_len, long long chunks,
                 uint32_t* __restrict__ partial) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  Jac acc;
  set_inf(acc);
  const long long s = chunk_start[c];
  const int len = chunk_len[c];
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
  for (int e = 0; e < len; ++e) {
    const int signed_i = idx[s + e];
    const bool neg = signed_i < 0;
    const uint32_t* pt = points + 16ll * (neg ? ~signed_i : signed_i);
    uint32_t x[8], y[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k] = pt[k];
      y[k] = pt[8 + k];
    }
    if (neg) bn254::sub<Fq>(y, zero, y);  // q - y; infinity's 0 stays 0
    jac_add_affine(acc, x, y);
  }
  store_jac(partial + 24 * c, acc);
}

__global__ void __launch_bounds__(THREADS)
    bucket_kernel(const uint32_t* __restrict__ partial,
                  const long long* __restrict__ bucket_chunk0,
                  const int* __restrict__ bucket_chunks,
                  uint32_t* __restrict__ buckets) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= WINDOWS * BUCKETS) return;
  Jac acc, q;
  set_inf(acc);
  const long long c0 = bucket_chunk0[b];
#pragma unroll 1
  for (int k = 0; k < bucket_chunks[b]; ++k) {
    load_jac(q, partial + 24 * (c0 + k));
    jac_add(acc, q);
  }
  store_jac(buckets + 24 * b, acc);
}

// The digit of member t of bit slice b: the t-th of 1 .. 127 with bit b
// set (b < 7), or 128 (b = 7, t = 0).
__device__ __forceinline__ int slice_digit(int b, int t) {
  if (b == WINDOW_BITS - 1) return 128;
  return ((t >> b) << (b + 1)) | (1 << b) | (t & ((1 << b) - 1));
}

// Slice (w, b) = thread / SLICE_LANES; its lane j adds members j, j + 8,
// ..., then 3 butterfly steps give every lane the slice's sum. Every lane
// runs every step (the shuffles need the whole warp).
__global__ void __launch_bounds__(THREADS)
    slice_kernel(const uint32_t* __restrict__ buckets,
                 uint32_t* __restrict__ slices) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int slice = t / SLICE_LANES, j = t % SLICE_LANES;
  const int w = slice / WINDOW_BITS, b = slice % WINDOW_BITS;
  const int members = b == WINDOW_BITS - 1 ? 1 : SLICE_MEMBERS;
  Jac acc, q;
  set_inf(acc);
  constexpr int STEPS = SLICE_MEMBERS / SLICE_LANES + 3;
#pragma unroll 1
  for (int step = 0; step < STEPS; ++step) {
    const int m = step * SLICE_LANES + j;
    if (step < SLICE_MEMBERS / SLICE_LANES) {
      if (m >= members) continue;
      load_jac(q, buckets + 24 * (w * BUCKETS + slice_digit(b, m) - 1));
    } else {
      const int mask = 1 << (step - SLICE_MEMBERS / SLICE_LANES);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        q.x[k] = __shfl_xor_sync(0xffffffffu, acc.x[k], mask);
        q.y[k] = __shfl_xor_sync(0xffffffffu, acc.y[k], mask);
        q.z[k] = __shfl_xor_sync(0xffffffffu, acc.z[k], mask);
      }
    }
    jac_add(acc, q);
  }
  if (j == 0) store_jac(slices + 24 * slice, acc);
}

__global__ void __launch_bounds__(WINDOWS)
    window_kernel(const uint32_t* __restrict__ slices,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t win[WINDOWS * 24];
  const int w = threadIdx.x;
  Jac acc, q;
  load_jac(acc, slices + 24 * (w * WINDOW_BITS + WINDOW_BITS - 1));
#pragma unroll 1
  for (int b = WINDOW_BITS - 2; b >= 0; --b) {
    jac_double(acc);
    load_jac(q, slices + 24 * (w * WINDOW_BITS + b));
    jac_add(acc, q);
  }
  store_jac(win + 24 * w, acc);
  __syncthreads();
  if (w != 0) return;
  load_jac(acc, win + 24 * (WINDOWS - 1));
#pragma unroll 1
  for (int j = WINDOWS - 2; j >= 0; --j) {
#pragma unroll 1
    for (int k = 0; k < WINDOW_BITS; ++k) jac_double(acc);
    load_jac(q, win + 24 * j);
    jac_add(acc, q);
  }
  store_jac(out, acc);
}

unsigned grid_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// The number of buckets (windows x |digits|) the bucket arrays hold.
int bt_msm_buckets() { return WINDOWS * BUCKETS; }

// The number of bit slices (windows x bits) the slice array holds.
int bt_msm_slices() { return WINDOWS * WINDOW_BITS; }

// sum_i s_i P_i into out (24 u32: Jacobian X, Y, Z in Montgomery form).
// partial: (chunks, 24), buckets: (4096, 24) and slices: (256, 24) u32
// scratch. Four launches on `stream`; returns cudaGetLastError() after
// the last.
int bt_msm_run(const uint32_t* points, const int* idx,
               const long long* chunk_start, const int* chunk_len,
               long long chunks, const long long* bucket_chunk0,
               const int* bucket_chunks, uint32_t* partial,
               uint32_t* buckets, uint32_t* slices, uint32_t* out,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chunks > 0)
    chunk_kernel<<<grid_of(chunks), THREADS, 0, st>>>(
        points, idx, chunk_start, chunk_len, chunks, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bucket_kernel<<<grid_of(WINDOWS * BUCKETS), THREADS, 0, st>>>(
      partial, bucket_chunk0, bucket_chunks, buckets);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long slice_threads = WINDOWS * WINDOW_BITS * SLICE_LANES;
  slice_kernel<<<grid_of(slice_threads), THREADS, 0, st>>>(buckets, slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  window_kernel<<<1, WINDOWS, 0, st>>>(slices, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
