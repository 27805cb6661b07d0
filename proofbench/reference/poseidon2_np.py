"""Pure-numpy Poseidon2 (canonical domain) for host-side hashing.

Frozen copy of `boundless_tpu_torch/core/poseidon2_np.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/core/poseidon2_np.py`, on the port's
constants: the executor's keccak claim digest, the recursion claims and
the memory page tree hash here, with no device dispatch. Bit-identical
to `core/poseidon2.py` after `from_mont`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import field as F
from . import poseidon2 as P2

P = F.P
WIDTH = P2.WIDTH
RATE = P2.RATE

_EXT_RC, _INT_RC, _MU = P2.canonical_constants()
M4 = np.array([[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]],
               dtype=np.int64)


def _external_linear_np(state):
    """y_i = M4 @ (chunk_i + S), S = the sum of all six chunks."""
    s = state.reshape(*state.shape[:-1], 6, 4)
    tot = s.sum(axis=-2) % P
    y = (s + tot[..., None, :]) % P
    return (np.einsum("ij,...j->...i", M4, y) % P).reshape(state.shape)


def _sbox7(x):
    x2 = x * x % P
    x3 = x2 * x % P
    return x3 * x3 % P * x % P


def permute_np(states: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation on canonical int64 (..., 24)."""
    st = np.asarray(states, dtype=np.int64) % P
    st = _external_linear_np(st)
    half = P2.ROUNDS_FULL // 2
    for r in range(half):
        st = _external_linear_np(_sbox7((st + _EXT_RC[r]) % P))
    for r in range(P2.ROUNDS_PARTIAL):
        v = st.copy()
        v[..., 0] = _sbox7((st[..., 0] + int(_INT_RC[r])) % P)
        st = (v.sum(axis=-1, keepdims=True) % P + _MU * v) % P
    for r in range(half, P2.ROUNDS_FULL):
        st = _external_linear_np(_sbox7((st + _EXT_RC[r]) % P))
    return st


def hash_elems_np(elems: Sequence[int]) -> tuple:
    """Sponge hash of canonical elements (zero-padded rate-16 blocks)."""
    vals = np.asarray(list(elems), dtype=np.int64) % P
    nblocks = max(1, -(-len(vals) // RATE))
    pad = np.zeros(nblocks * RATE, dtype=np.int64)
    pad[: len(vals)] = vals
    st = np.zeros(WIDTH, dtype=np.int64)
    for b in range(nblocks):
        st[:RATE] = (st[:RATE] + pad[b * RATE:(b + 1) * RATE]) % P
        st = permute_np(st)
    return tuple(int(x) for x in st[:8])


def hash_pair_np(left: Sequence[int], right: Sequence[int]) -> tuple:
    """2-to-1 compression of two 8-word digests (one block absorbing
    left || right; `poseidon2.hash_pair` after `from_mont`)."""
    st = np.zeros(WIDTH, dtype=np.int64)
    st[:8] = np.asarray(list(left), dtype=np.int64) % P
    st[8:16] = np.asarray(list(right), dtype=np.int64) % P
    return tuple(int(x) for x in permute_np(st)[:8])
