// Baby Bear field helpers for Hopper kernels (shared by every kernel).
//
// Elements are uint32 words in [0, P), Montgomery form with R = 2^32 — the
// words the JAX package stores and the port keeps in int32 tensors. Where
// the TPU build assembled a 32x32->64 product from four 16x16 partials
// (boundless_tpu/core/field.py mul32_wide), the GPU has the wide multiply
// natively: one IMAD.WIDE-class product plus a Montgomery reduction.
#pragma once

#include <stdint.h>

namespace bb {

constexpr uint32_t P = 2013265921u;   // 15 * 2^27 + 1
constexpr uint32_t NP = 2013265919u;  // -P^{-1} mod 2^32

// The final correction of add, sub and mul is an unsigned min of the two
// candidates, the wrong one of which wraps above the right one (s - P when
// s < P; d = a - b when a < b). nvcc emits the correction's add and the
// min as one VIADDMNMX, so an add is two dependent instructions, not three
// (compare, add, select).
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2P < 2^32
  return min(s, s - P);
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t d = a - b;
  return min(d, d + P);
}

// t * R^-1 mod P (Montgomery reduction) for any t < P * 2^32: m * P <
// P * 2^32 too, so t + m * P fits in 64 bits; the quotient is < 2P and one
// conditional subtract reduces.
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  uint32_t m = (uint32_t)t * NP;
  uint32_t r = (uint32_t)((t + (uint64_t)m * P) >> 32);
  return min(r, r - P);
}

// a * b * R^-1 mod P: t = a * b < P^2.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return redc((uint64_t)a * b);
}

}  // namespace bb
