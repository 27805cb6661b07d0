// BN254 field arithmetic for Hopper kernels: 8 x 32-bit limbs, Montgomery
// form with R = 2^256, templated on the modulus, so that the p254 sponge
// (csrc/poseidon254.cu, the scalar field r) and the MSM (csrc/msm.cu, the
// base field q) share one implementation.
//
// An element is uint32_t[8], least significant limb first, in [0, m). The
// product is CIOS (coarsely integrated operand scanning): for each limb of
// b, one row of 32x32->64 partial products accumulated with its carry in a
// 64-bit word, then one Montgomery step (m_i = t_0 * (-m^-1) mod 2^32,
// t = (t + m_i * m) / 2^32): 128 wide products a multiplication. Hopper has
// no 64-bit integer multiplier: each 32x32->64 product is an IMAD.WIDE
// (two 32-bit multiply-adds' worth of issue), so the product's cost is
// its 32-bit multiply-adds, which bound both kernels. Loops over limbs are
// unrolled, so every limb lives in a register.
//
// The moduli are below 2^254, so 2m < 2^256: a sum, a difference and a
// product each need at most one conditional subtraction or addition of m.
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

// r = t - m if (hi, t) >= m, else t (t < 2m; hi is t's carry limb).
template <class M>
__device__ __forceinline__ void reduce_once(uint32_t r[8], const uint32_t t[8],
                                            uint32_t hi) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t x = (uint64_t)t[j] - M::mod(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (x >> 32) & 1;
  }
  const bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = take ? d[j] : t[j];
}

// r = a * b * 2^-256 mod m (r may alias a or b).
template <class M>
__device__ __forceinline__ void mul(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a[j] * b[i];  // < 2^64
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t mi = t[0] * M::NP;
    c = ((uint64_t)t[0] + (uint64_t)mi * M::mod(0)) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)mi * M::mod(j);
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  reduce_once<M>(r, t, t[8]);
}

template <class M>
__device__ __forceinline__ void add(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<M>(r, s, (uint32_t)c);
}

template <class M>
__device__ __forceinline__ void sub(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t x = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (x >> 32) & 1;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;  // add m back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)d[j] + (M::mod(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// Canonical integer (< 2^256) -> Montgomery form.
template <class M>
__device__ __forceinline__ void to_mont(uint32_t r[8], const uint32_t a[8]) {
  uint32_t r2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r2[j] = M::r2(j);
  mul<M>(r, a, r2);
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
