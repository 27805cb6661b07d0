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

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2P < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// a * b * R^-1 mod P. t < P^2 < 2^62 and m * P < 2^63, so t + m * P fits
// in 64 bits; the quotient is < 2P and one conditional subtract reduces.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = (uint32_t)t * NP;
  uint32_t r = (uint32_t)((t + (uint64_t)m * P) >> 32);
  return r >= P ? r - P : r;
}

}  // namespace bb
