// BN254 field arithmetic for Hopper kernels: 8 x 32-bit limbs, Montgomery
// form with R = 2^256, templated on the modulus, so that the p254 sponge
// (csrc/poseidon254.cu, the scalar field r) and the MSM (csrc/msm.cu, the
// base field q) share one implementation.
//
// An element is uint32_t[8], least significant limb first. The moduli are
// below 2^254 (m / 2^256 < 0.19), so 2m < 2^256 and m * 2^256 > 5.29 m^2.
//
// The product (mul, mul_sum) is CIOS (coarsely integrated operand
// scanning, one Montgomery reduction a limb of b), with each row of
// partial products split into two independent carry chains: the products
// of the even limbs of a (lo and hi halves) fill the words 0..7 without
// overlapping, those of the odd limbs the words 1..8, so each half is one
// chain of multiply-adds through the carry flag, accumulated in its own
// array (E, and O one word up), and the two meet once a row (one add).
// The reduction adds m_i * modulus in the same two chains. A chain is one
// instruction a word (ptxas fuses a lo/hi pair into one wide multiply-add
// and keeps several chains in flight on the carry predicates), where one
// 64-bit accumulator through every partial product would make the whole
// product one dependent sequence. mul_sum keeps the sum of several
// products wide and reduces it once, so that a row of an MDS matrix is
// one reduction.
//
// Two builds of the same arithmetic. On the card each carry primitive
// below is one PTX instruction on the condition-code carry flag (mad.lo.cc,
// madc.hi.cc, add.cc, ...); a chain is consecutive calls (asm volatile
// keeps their order, and no other code between them uses the flag).
// Elsewhere (g++ on tests/cuda_emu.h) the same calls run in C++ on an
// explicit flag `Carry`: tier-1 tests run that twin, and only the card
// runs the PTX. `#ifdef __CUDA_ARCH__` picks the build.
//
// Ranges. mul and mul_sum return canonical values in [0, m) when the sum
// of the products is below m * 2^256 and every operand `a` is below 2m:
// one product of two operands below 2m (lazy sums), or up to three
// products of canonical operands (with the `b` of one of them below 2m).
// add_lazy leaves a sum in [0, 2m) for a product to take; add, sub and
// everything that a comparison or a store reads are canonical.
#pragma once

#include <stdint.h>

namespace bn254 {

// The base field q (curve coordinates).
struct Fq {
  static constexpr uint32_t NP = 0xe4866389u;  // -q^-1 mod 2^32
  __host__ __device__ static constexpr uint32_t mod(int i) {
    constexpr uint32_t m[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                               0x97816a91u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return m[i];
  }
  __host__ __device__ static constexpr uint32_t r2(int i) {  // 2^512 mod q
    constexpr uint32_t m[8] = {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu,
                               0xb5e71911u, 0x0a417ff6u, 0x47ab1effu,
                               0xcab8351fu, 0x06d89f71u};
    return m[i];
  }
};

// The scalar field r (the p254 sponge's felts).
struct Fr {
  static constexpr uint32_t NP = 0xefffffffu;  // -r^-1 mod 2^32
  __host__ __device__ static constexpr uint32_t mod(int i) {
    constexpr uint32_t m[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                               0x2833e848u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return m[i];
  }
  __host__ __device__ static constexpr uint32_t r2(int i) {  // 2^512 mod r
    constexpr uint32_t m[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u,
                               0x53fe3ab1u, 0x53bb8085u, 0x8c49833du,
                               0x7f4e44a5u, 0x0216d0b1u};
    return m[i];
  }
};

// 2^256 - m, limb i (m is odd, so only limb 0 takes the +1).
template <class M>
__host__ __device__ constexpr uint32_t neg_mod(int i) {
  return ~M::mod(i) + (i == 0 ? 1u : 0u);
}

// ---------------------------------------------------------------------------
// carry-flag primitives (see the top of the file)
// ---------------------------------------------------------------------------

struct Carry {
  uint32_t cf = 0;  // the twin's carry (borrow) flag; unused on the card
};

#ifdef __CUDA_ARCH__
#define BN254_ASM2(op)                                                   \
  uint32_t r;                                                            \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));            \
  return r;
#define BN254_ASM3(op)                                                   \
  uint32_t r;                                                            \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
  return r;
#endif

// a + b, carry out
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("add.cc.u32")
#else
  const uint64_t s = (uint64_t)a + b;
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// a + b + carry, carry out
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b,
                                            Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("addc.cc.u32")
#else
  const uint64_t s = (uint64_t)a + b + k.cf;
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// a + b + carry (the carry out is dropped)
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("addc.u32")
#else
  return a + b + k.cf;
#endif
}

// a - b, borrow out
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("sub.cc.u32")
#else
  k.cf = a < b;
  return a - b;
#endif
}

// a - b - borrow, borrow out
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b,
                                            Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("subc.cc.u32")
#else
  const uint64_t d = (uint64_t)a - b - k.cf;
  k.cf = (uint32_t)(d >> 32) & 1;
  return (uint32_t)d;
#endif
}

// a - b - borrow (the borrow out is dropped)
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM2("subc.u32")
#else
  return a - b - k.cf;
#endif
}

// lo(a * b) + c, carry out
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM3("mad.lo.cc.u32")
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// lo(a * b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM3("madc.lo.cc.u32")
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + k.cf;
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// hi(a * b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c, Carry& k) {
#ifdef __CUDA_ARCH__
  BN254_ASM3("madc.hi.cc.u32")
#else
  const uint64_t s = (uint64_t)__umulhi(a, b) + c + k.cf;
  k.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

// The running value of a product: V = E + O * 2^32, E = e[0..8], O =
// o[0..7] (o[k] at word k + 1). Before a row V < (K + 1) m for K products
// of canonical `a`, so after a row and its reduction V < 2^288: e[8]
// takes E's top carry and O never carries out of o[7].
struct Wide {
  uint32_t e[9], o[8];
};

// V = a * b (the first row of the first product: no accumulation).
__device__ __forceinline__ void row_first(Wide& w, const uint32_t a[8],
                                          uint32_t b) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    w.e[j] = a[j] * b;
    w.e[j + 1] = __umulhi(a[j], b);
    w.o[j] = a[j + 1] * b;
    w.o[j + 1] = __umulhi(a[j + 1], b);
  }
  w.e[8] = 0;
}

// V += a * b: the even chain into E, the odd chain into O. `in` is a
// carry into word 1 from the last shift (merge_carry), taken by the odd
// chain's first multiply-add, or 0.
__device__ __forceinline__ void row_mad(Wide& w, const uint32_t a[8],
                                        uint32_t b, Carry& k, bool in) {
  w.o[0] = in ? madc_lo_cc(a[1], b, w.o[0], k) : mad_lo_cc(a[1], b, w.o[0], k);
  w.o[1] = madc_hi_cc(a[1], b, w.o[1], k);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    w.o[j] = madc_lo_cc(a[j + 1], b, w.o[j], k);
    w.o[j + 1] = madc_hi_cc(a[j + 1], b, w.o[j + 1], k);
  }
  w.e[0] = mad_lo_cc(a[0], b, w.e[0], k);
  w.e[1] = madc_hi_cc(a[0], b, w.e[1], k);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    w.e[j] = madc_lo_cc(a[j], b, w.e[j], k);
    w.e[j + 1] = madc_hi_cc(a[j], b, w.e[j + 1], k);
  }
  w.e[8] = addc(w.e[8], 0, k);
}

// V = (V + m_i * modulus) / 2^32, m_i = e[0] * NP: e[0] becomes 0 (word 0
// of V is e[0] alone), then the words move down one. Word 0 of the result
// is e[1] + o[0]: it is left as the sum's low half in e[0] and its carry
// in `k`, for the next row's odd chain (row_mad with in = true); after
// the last row, finish() adds it.
template <class M>
__device__ __forceinline__ void reduce_row(Wide& w, Carry& k) {
  const uint32_t mi = w.e[0] * M::NP;
  w.e[0] = mad_lo_cc(M::mod(0), mi, w.e[0], k);  // 0
  w.e[1] = madc_hi_cc(M::mod(0), mi, w.e[1], k);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    w.e[j] = madc_lo_cc(M::mod(j), mi, w.e[j], k);
    w.e[j + 1] = madc_hi_cc(M::mod(j), mi, w.e[j + 1], k);
  }
  w.e[8] = addc(w.e[8], 0, k);
  w.o[0] = mad_lo_cc(M::mod(1), mi, w.o[0], k);
  w.o[1] = madc_hi_cc(M::mod(1), mi, w.o[1], k);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    w.o[j] = madc_lo_cc(M::mod(j + 1), mi, w.o[j], k);
    w.o[j + 1] = madc_hi_cc(M::mod(j + 1), mi, w.o[j + 1], k);
  }
  // shift: the new E is O (words 0..7), the new O is e[2..8] (words 1..7
  // of the shifted value), and e[1], at word 0, is added into the new E.
  Wide n;
  n.e[0] = add_cc(w.o[0], w.e[1], k);  // carry into word 1: the next odd chain
#pragma unroll
  for (int j = 1; j < 8; ++j) n.e[j] = w.o[j];
  n.e[8] = 0;
#pragma unroll
  for (int j = 0; j < 7; ++j) n.o[j] = w.e[j + 2];
  n.o[7] = 0;
  w = n;
}

// r = V reduced below m, V = E + O * 2^32 + carry * 2^32 (< 2m).
template <class M>
__device__ __forceinline__ void finish(uint32_t r[8], const Wide& w,
                                       Carry& k) {
  uint32_t t[8];
  t[0] = w.e[0];
  t[1] = addc_cc(w.e[1], w.o[0], k);
#pragma unroll
  for (int j = 2; j < 8; ++j) t[j] = addc_cc(w.e[j], w.o[j - 1], k);
  const uint32_t hi = addc(w.e[8], w.o[7], k);
  // t + hi * 2^256 - m: the carry out of t + (2^256 - m) plus hi
  uint32_t d[8];
  Carry s;
  d[0] = add_cc(t[0], neg_mod<M>(0), s);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = addc_cc(t[j], neg_mod<M>(j), s);
  const bool take = addc(hi, 0, s) != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = take ? d[j] : t[j];
}

// r = (sum_k a_k * b_k) * 2^-256 mod m, K products, one reduction a limb
// of b (see Ranges at the top; r may alias an operand).
template <class M, int K>
__device__ __forceinline__ void mul_sum(uint32_t r[8],
                                        const uint32_t (&a)[K][8],
                                        const uint32_t (&b)[K][8]) {
  Wide w;
  Carry k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      if (i == 0 && p == 0) {
        row_first(w, a[0], b[0][0]);
      } else {
        row_mad(w, a[p], b[p][i], k, i > 0 && p == 0);
      }
    }
    reduce_row<M>(w, k);
  }
  finish<M>(r, w, k);
}

// r = a * b * 2^-256 mod m (r may alias a or b).
template <class M>
__device__ __forceinline__ void mul(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t aa[1][8], bb[1][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    aa[0][j] = a[j];
    bb[0][j] = b[j];
  }
  mul_sum<M, 1>(r, aa, bb);
}

// ---------------------------------------------------------------------------
// sums, conversions, comparisons
// ---------------------------------------------------------------------------

// r = t - m if (hi, t) >= m, else t (t < 2m; hi is t's carry limb).
template <class M>
__device__ __forceinline__ void reduce_once(uint32_t r[8], const uint32_t t[8],
                                            uint32_t hi) {
  uint32_t d[8];
  Carry k;
  d[0] = add_cc(t[0], neg_mod<M>(0), k);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = addc_cc(t[j], neg_mod<M>(j), k);
  const bool take = addc(hi, 0, k) != 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = take ? d[j] : t[j];
}

// r = a + b, not reduced: in [0, 2m) for canonical a and b.
__device__ __forceinline__ void add_lazy(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  Carry k;
  r[0] = add_cc(a[0], b[0], k);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc(a[j], b[j], k);
  r[7] = addc(a[7], b[7], k);
}

template <class M>
__device__ __forceinline__ void add(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t s[8];
  Carry k;
  s[0] = add_cc(a[0], b[0], k);
#pragma unroll
  for (int j = 1; j < 8; ++j) s[j] = addc_cc(a[j], b[j], k);
  reduce_once<M>(r, s, addc(0, 0, k));
}

template <class M>
__device__ __forceinline__ void sub(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t d[8];
  Carry k;
  d[0] = sub_cc(a[0], b[0], k);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc(a[j], b[j], k);
  const uint32_t mask = subc(0, 0, k);  // all ones on a borrow: add m back
  Carry c;
  r[0] = add_cc(d[0], M::mod(0) & mask, c);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc(d[j], M::mod(j) & mask, c);
  r[7] = addc(d[7], M::mod(7) & mask, c);
}

// Integer (< 2^256) -> Montgomery form, canonical.
template <class M>
__device__ __forceinline__ void to_mont(uint32_t r[8], const uint32_t a[8]) {
  uint32_t r2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r2[j] = M::r2(j);
  mul<M>(r, r2, a);  // R^2 mod m is the operand below m
}

// Montgomery form -> canonical integer in [0, m).
template <class M>
__device__ __forceinline__ void from_mont(uint32_t r[8], const uint32_t a[8]) {
  uint32_t one[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) one[j] = j == 0;
  mul<M>(r, a, one);
}

__device__ __forceinline__ bool is_zero(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ bool eq(const uint32_t a[8], const uint32_t b[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j] ^ b[j];
  return acc == 0;
}

__device__ __forceinline__ void copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = a[j];
}

}  // namespace bn254
