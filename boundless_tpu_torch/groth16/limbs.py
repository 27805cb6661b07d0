"""BN254 base-field limbs for the card's MSM: 8 x 32-bit, Montgomery R = 2^256.

Counterpart of `boundless_tpu/groth16/limbs.py`, in the layout of the CUDA
kernel (`csrc/bn254_field.cuh`) instead of the reference's 13-bit x 20
limbs (R = 2^260, sized for the TPU's int32 lanes): an element of Fq is 8
little-endian u32 limbs in Montgomery form. Host conversions (`to_mont`,
`from_mont`, `to_limbs`, `from_limbs`) work on Python ints and numpy; the
plain torch arithmetic (`mul`, `add`, `sub`, `is_zero`, `eq`) works on
(..., 8) int64 tensors holding the limbs in [0, 2^32), on any device. It
is the MSM's plain version (`groth16/msm_device.py`), so it is written for
clarity: each product splits the limbs into 16-bit digits (so a partial
product and a 16-term column sum fit int64), and reduces once, by 16
Montgomery digit steps.
"""

from __future__ import annotations

import numpy as np
import torch

from .bn254 import P as N_INT

B = 32  # limb bits
L = 8  # limbs (256 bits >= 254)
MASK = (1 << B) - 1
R_INT = 1 << (B * L)
R_MOD_N = R_INT % N_INT
R2_MOD_N = R_INT * R_INT % N_INT
R_INV = pow(R_INT, -1, N_INT)

_D = 16  # 16-bit digits of the plain product
_N16 = [(N_INT >> (16 * i)) & 0xFFFF for i in range(_D)]
_NP16 = (-pow(N_INT, -1, 1 << 16)) % (1 << 16)  # -N^-1 mod 2^16


def to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (B * i)) & MASK for i in range(L)],
                    dtype=np.uint32)


def from_limbs(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.uint64)
    return sum(int(v) << (B * i) for i, v in enumerate(arr))


def to_mont(x: int) -> np.ndarray:
    return to_limbs(x * R_MOD_N % N_INT)


def from_mont(limbs) -> int:
    return from_limbs(limbs) * R_INV % N_INT


# ---------------------------------------------------------------------------
# plain torch arithmetic on (..., 8) int64 limbs
# ---------------------------------------------------------------------------


def _digits(a):
    """(..., 8) 32-bit limbs -> (..., 16) 16-bit digits."""
    return torch.stack([a & 0xFFFF, a >> 16], dim=-1).flatten(-2)


def _limbs(d):
    """(..., 16) 16-bit digits -> (..., 8) 32-bit limbs."""
    return d[..., 0::2] | (d[..., 1::2] << 16)


def _propagate(t):
    """Carry (or borrow) through (..., k) int64 digits -> (16-bit digits,
    final carry), the carry signed (a borrow is -1)."""
    out = []
    carry = torch.zeros_like(t[..., 0])
    for i in range(t.shape[-1]):
        c = t[..., i] + carry
        out.append(c & 0xFFFF)
        carry = c >> 16  # arithmetic shift: floors negative values
    return torch.stack(out, dim=-1), carry


def _n16(device):
    return torch.tensor(_N16, dtype=torch.int64, device=device)


def _cond_sub_n(d, carry):
    """Digits d (value carry * 2^256 + d < 2N) -> value mod N as limbs."""
    diff, borrow = _propagate(d - _n16(d.device))
    keep = (borrow < 0) & (carry == 0)  # d < N: nothing to subtract
    return _limbs(torch.where(keep[..., None], d, diff))


def add(a, b):
    """(a + b) mod N."""
    s, carry = _propagate(_digits(a) + _digits(b))
    return _cond_sub_n(s, carry)


def sub(a, b):
    """(a - b) mod N."""
    d, borrow = _propagate(_digits(a) - _digits(b))
    fixed, _ = _propagate(d + _n16(d.device))
    return _limbs(torch.where((borrow < 0)[..., None], fixed, d))


_COLS = {}


def _columns(device):
    """Column index i + j of each of the 16 x 16 digit products."""
    if device not in _COLS:
        i = torch.arange(_D, device=device)
        _COLS[device] = (i[:, None] + i[None, :]).reshape(-1)
    return _COLS[device]


def mul(a, b):
    """Montgomery product a * b * 2^-256 mod N."""
    a, b = torch.broadcast_tensors(a, b)
    ad, bd = _digits(a), _digits(b)
    prod = (ad[..., :, None] * bd[..., None, :]).flatten(-2)  # < 2^32 each
    t = torch.zeros(a.shape[:-1] + (2 * _D + 1,), dtype=torch.int64,
                    device=a.device)
    t.index_add_(t.dim() - 1, _columns(a.device), prod)  # columns < 2^36
    n16 = _n16(a.device)
    for i in range(_D):
        m = ((t[..., i] & 0xFFFF) * _NP16) & 0xFFFF
        t[..., i:i + _D] += m[..., None] * n16
        t[..., i + 1] += t[..., i] >> 16  # t[i] is now 0 mod 2^16
    d, carry = _propagate(t[..., _D:])
    return _cond_sub_n(d[..., :_D], d[..., _D] + (carry << 16))


def is_zero(a):
    """(...,) bool: all limbs zero."""
    return torch.all(a == 0, dim=-1)


def eq(a, b):
    return torch.all(a == b, dim=-1)


def tensor(limb_rows, device="cpu"):
    """Limb rows (numpy u32, (..., 8)) -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(limb_rows, dtype=np.int64)).to(device)
