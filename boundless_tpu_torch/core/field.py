"""Baby Bear field arithmetic on torch tensors (Montgomery form, R = 2^32).

Counterpart of `boundless_tpu/core/field.py`. Elements are `torch.int32`
tensors holding the same Montgomery words as the JAX package's uint32
arrays: P = 15 * 2^27 + 1 < 2^31, so every reduced word is a non-negative
int32. Products upcast to int64 (two reduced words multiply to < 2^62)
and reduce before anything is summed, so no intermediate overflows.

The Montgomery product is computed as (a * b mod P) * R^-1 mod P, which
equals the JAX package's uint32 Montgomery reduction bit for bit (both are
the unique reduced representative). The TPU workarounds of the reference
(16x16-partial wide products, the Baby Bear-shaped reduction,
`enable_u64`) have no counterpart: int64 products are native here.

The quartic extension F_p[x]/(x^4 - 11) keeps its coefficients on a
trailing axis of size 4, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import upload as UK
from ..utils import profiling

P = 2013265921  # 15 * 2**27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative generator of F_p^*
R_MOD_P = (1 << 32) % P  # Montgomery "one"
R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod P
ROU_FWD_27 = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
BETA = 11  # extension field: x^4 - BETA
EXT_DEGREE = 4

ROU_FWD = [1] * (TWO_ADICITY + 1)
ROU_FWD[TWO_ADICITY] = ROU_FWD_27
for _i in range(TWO_ADICITY - 1, -1, -1):
    ROU_FWD[_i] = (ROU_FWD[_i + 1] * ROU_FWD[_i + 1]) % P
ROU_REV = [pow(r, P - 2, P) for r in ROU_FWD]
assert ROU_FWD[1] == P - 1

ONE = R_MOD_P  # Montgomery encoding of 1
I32 = torch.int32


def mont(x: int) -> int:
    """Python-int canonical -> Montgomery encoding (exact)."""
    return (x % P) * (1 << 32) % P


def unmont(x: int) -> int:
    return x * R_INV % P


def mont_np(x) -> np.ndarray:
    """Canonical integers (any int array) -> Montgomery int64 numpy."""
    return np.asarray((np.asarray(x, dtype=np.int64) % P) * (1 << 32) % P)


# ---------------------------------------------------------------------------
# Base field
# ---------------------------------------------------------------------------


def add(a, b):
    # a + (b - P) lies in [-P, P): no int32 overflow, one conditional fix.
    s = a + (b - P)
    return torch.where(s < 0, s + P, s)


def sub(a, b):
    s = a - b
    return torch.where(s < 0, s + P, s)


def neg(a):
    return torch.where(a == 0, a, P - a)


def _reduce(t):
    """Non-negative int64 t -> t * R^-1 mod P as an int32 word."""
    return (t % P * R_INV % P).to(I32)


def mul(a, b):
    """Montgomery product a * b * R^-1 mod P (int32 in, int32 out)."""
    return _reduce(a.to(torch.int64) * b.to(torch.int64))


def to_mont(x):
    """Canonical int tensor in [0, P) -> Montgomery form."""
    return (x.to(torch.int64) * (1 << 32) % P).to(I32)


def from_mont(x):
    """Montgomery form -> canonical int32 in [0, P)."""
    return (x.to(torch.int64) * R_INV % P).to(I32)


def fp(x, device="cpu"):
    """Python / numpy canonical ints -> Montgomery int32 tensor."""
    return torch.from_numpy(mont_np(x).astype(np.int32)).to(device)


def upload(words, device):
    """A trace handed from the host to `device`: canonical words ->
    Montgomery int32 there, the copy and the conversion under one
    synchronised `upload` span of the tracer. On a CUDA device the int64
    rows are copied as they lie and converted by a kernel on the card
    (`kernels/upload.py`, span attr `route="card"`); elsewhere `fp` converts
    them on the host (`route="host"`). Both give the same words."""
    on_card = torch.device(device).type == "cuda"
    with profiling.span("upload", sync=True, device=device,
                        route="card" if on_card else "host"):
        if on_card:
            return UK.upload(words, device)
        return fp(words, device)


def const(c: int, device="cpu"):
    """Canonical int -> 0-d Montgomery tensor."""
    return torch.tensor(mont(int(c)), dtype=I32, device=device)


def pow_const(a, e: int):
    """a ** e for a static Python exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        return torch.full_like(a, ONE)
    return result


def inv(a):
    """Batched inversion via Fermat: a^(P-2). inv(0) = 0."""
    return pow_const(a, P - 2)


def sum_mod(x, dim: int = 0):
    """Modular sum along `dim`. Exact: < 2^32 reduced terms fit int64."""
    return (x.to(torch.int64).sum(dim) % P).to(I32)


# ---------------------------------------------------------------------------
# Quartic extension  F_p[x] / (x^4 - 11), trailing dim 4
# ---------------------------------------------------------------------------


def ext_from_base(a):
    """Embed a base-field tensor into the extension (trailing dim 4)."""
    out = torch.zeros(a.shape + (EXT_DEGREE,), dtype=I32, device=a.device)
    out[..., 0] = a
    return out


def ext(coeffs, device="cpu"):
    """Canonical int coeffs (shape (..., 4)) -> Montgomery ext tensor."""
    arr = np.asarray(coeffs, dtype=np.int64)
    assert arr.shape[-1] == EXT_DEGREE
    return fp(arr, device)


ext_add = add
ext_sub = sub
ext_neg = neg


def ext_scale(a, s):
    """Multiply ext element(s) by base-field scalar(s). s broadcasts."""
    return mul(a, s[..., None])


def ext_mul(a, b):
    """Schoolbook quartic multiply with x^4 = 11.

    Each of the 16 partial products is reduced mod P first; the (at most
    4 + 11*3) reduced terms of a coefficient then sum far below 2^63."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)

    def p(x, y):
        return x * y % P

    c0 = p(a0, b0) + BETA * (p(a1, b3) + p(a2, b2) + p(a3, b1))
    c1 = p(a0, b1) + p(a1, b0) + BETA * (p(a2, b3) + p(a3, b2))
    c2 = p(a0, b2) + p(a1, b1) + p(a2, b0) + BETA * p(a3, b3)
    c3 = p(a0, b3) + p(a1, b2) + p(a2, b1) + p(a3, b0)
    return _reduce(torch.stack([c0, c1, c2, c3], dim=-1))


def ext_pow_const(a, e: int):
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else ext_mul(result, base)
        e >>= 1
        if e:
            base = ext_mul(base, base)
    if result is None:
        return ext_ones(a.shape[:-1], a.device)
    return result


def ext_ones(shape=(), device="cpu"):
    out = torch.zeros(tuple(shape) + (EXT_DEGREE,), dtype=I32, device=device)
    out[..., 0] = ONE
    return out


def ext_zeros(shape=(), device="cpu"):
    return torch.zeros(tuple(shape) + (EXT_DEGREE,), dtype=I32, device=device)


def ext_inv(a):
    """Inverse in the quartic extension via the norm map (inv(0) = 0).

    a * a(-x) has only even coefficients e0 + e2 x^2; its norm
    e0^2 - 11 e2^2 is a base-field element inverted with Fermat."""
    abar = a.clone()
    abar[..., 1] = neg(a[..., 1])
    abar[..., 3] = neg(a[..., 3])
    n1 = ext_mul(a, abar)
    e0, e2 = n1[..., 0], n1[..., 2]
    beta = torch.full_like(e0, mont(BETA))
    norm = sub(mul(e0, e0), mul(beta, mul(e2, e2)))
    n1c = torch.zeros_like(n1)
    n1c[..., 0] = e0
    n1c[..., 2] = neg(e2)
    return ext_scale(ext_mul(abar, n1c), inv(norm))
