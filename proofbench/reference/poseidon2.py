"""Poseidon2 over Baby Bear: constants and the plain torch sponge.

Frozen copy of `boundless_tpu_torch/core/poseidon2.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/core/poseidon2.py` (and of the plain twin
inside `poseidon2_pallas.py`): width 24, rate 16, capacity 8, digest 8,
x^7 S-box, 4 + 21 + 4 rounds, external matrix circ(2*M4, M4, ...) and
internal matrix J + diag(mu). The constants are regenerated here from the
same SHA-256 counter derivation, so the tables are identical.

This module is the plain version: `hash_rows` replaces the reference's
`hash_elems`, `hash_rows_cells` and the Pallas kernels' plain twin. The
prover does not call it directly — it calls `kernels/poseidon2.py`, which
runs the CUDA sponge on a GPU tensor and this code on a CPU tensor.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from . import field as F

WIDTH = 24
RATE = 16
CAPACITY = 8
DIGEST_WORDS = 8
ROUNDS_FULL = 8  # 4 + 4
ROUNDS_PARTIAL = 21

# Internal-matrix diagonal spec: ("i", c) = +c, ("n", c) = -c,
# ("h", k) = 2^-k, ("nh", k) = -2^-k (the reference's DIAG_SPEC).
DIAG_SPEC = (
    ("i", 1), ("i", 2), ("i", 3), ("i", 4), ("i", 5), ("i", 6),
    ("i", 8), ("i", 12), ("i", 16),
    ("n", 2), ("n", 3), ("n", 4), ("n", 5), ("n", 6), ("n", 8),
    ("n", 12), ("n", 16),
    ("h", 1), ("h", 2), ("h", 3), ("h", 4),
    ("nh", 1), ("nh", 2), ("nh", 3),
)


def _nothing_up_my_sleeve(tag: bytes, count: int) -> np.ndarray:
    """Deterministic canonical field constants from SHA-256 counter mode."""
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        h = hashlib.sha256(b"boundless-tpu.poseidon2.babybear.v1:" + tag
                           + b":" + str(i).encode()).digest()
        out[i] = int.from_bytes(h[:8], "little") % F.P
    return out


def _diag_values() -> np.ndarray:
    inv2 = (F.P + 1) // 2
    out = []
    for op, k in DIAG_SPEC:
        if op == "i":
            out.append(k % F.P)
        elif op == "n":
            out.append((-k) % F.P)
        elif op == "h":
            out.append(pow(inv2, k, F.P))
        else:  # "nh"
            out.append((-pow(inv2, k, F.P)) % F.P)
    assert len(set(out)) == WIDTH and 0 not in out
    return np.array(out, dtype=np.int64)


@functools.lru_cache(maxsize=1)
def canonical_constants():
    """(external rc (8, 24), internal rc (21,), mu (24,)) canonical int64."""
    ext_rc = _nothing_up_my_sleeve(b"ext", ROUNDS_FULL * WIDTH).reshape(
        ROUNDS_FULL, WIDTH)
    int_rc = _nothing_up_my_sleeve(b"int", ROUNDS_PARTIAL)
    return ext_rc, int_rc, _diag_values()


@functools.lru_cache(maxsize=1)
def constants():
    """The same tables in Montgomery form (int64 numpy)."""
    return tuple(F.mont_np(t) for t in canonical_constants())


@functools.lru_cache(maxsize=None)
def _device_constants(device):
    ext_rc, int_rc, mu = constants()
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)  # noqa: E731
    return t(ext_rc), t(int_rc), t(mu)


def _sbox(x):
    x2 = F.mul(x, x)
    x3 = F.mul(x2, x)
    x6 = F.mul(x3, x3)
    return F.mul(x6, x)


def _m4(x0, x1, x2, x3):
    """M4 @ (x0..x3) via the Poseidon2 paper's 14-add sequence."""
    t0 = F.add(x0, x1)
    t1 = F.add(x2, x3)
    t2 = F.add(F.add(x1, x1), t1)  # 2*x1 + t1
    t3 = F.add(F.add(x3, x3), t0)  # 2*x3 + t0
    d1 = F.add(t1, t1)
    t4 = F.add(F.add(d1, d1), t3)  # 4*t1 + t3
    d0 = F.add(t0, t0)
    t5 = F.add(F.add(d0, d0), t2)  # 4*t0 + t2
    return F.add(t3, t5), t5, F.add(t2, t4), t4


def _external_linear(s):
    """M_E @ state (..., 24): per-chunk M4 plus the chunk-sum broadcast."""
    s6 = s.reshape(s.shape[:-1] + (WIDTH // 4, 4))
    y = torch.stack(_m4(*s6.unbind(-1)), dim=-1)  # (..., 6, 4)
    tot = F.sum_mod(y, dim=-2)
    return F.add(y, tot.unsqueeze(-2)).reshape(s.shape)


def permute(state):
    """Poseidon2 permutation on a (..., 24) Montgomery int32 state."""
    ext_rc, int_rc, mu = _device_constants(state.device)
    half = ROUNDS_FULL // 2
    s = _external_linear(state)
    for r in range(half):
        s = _external_linear(_sbox(F.add(s, ext_rc[r])))
    for r in range(ROUNDS_PARTIAL):
        s = s.clone()
        s[..., 0] = _sbox(F.add(s[..., 0], int_rc[r]))
        s = F.add(F.mul(s, mu), F.sum_mod(s, dim=-1).unsqueeze(-1))
    for r in range(half, ROUNDS_FULL):
        s = _external_linear(_sbox(F.add(s, ext_rc[r])))
    return s


def hash_rows(matrix, init=None, out_words: int = DIGEST_WORDS):
    """Sponge-hash each row of an (N, C) Montgomery matrix -> (N, out_words).

    Rate-16 absorb by field addition into the state, zero-padded final
    block, at least one block (C = 0 hashes one zero block). `init`
    (N, 24) replaces the all-zero initial state, so `hash_rows` of an
    (N, 0) matrix with `init` is one permutation of `init`. Plain version
    of the CUDA sponge (`kernels/poseidon2.py`)."""
    n, c = matrix.shape
    blocks = max(1, -(-c // RATE))
    padded = torch.zeros((n, blocks * RATE), dtype=F.I32, device=matrix.device)
    padded[:, :c] = matrix
    state = (torch.zeros((n, WIDTH), dtype=F.I32, device=matrix.device)
             if init is None else init)
    for b in range(blocks):
        top = F.add(state[:, :RATE], padded[:, b * RATE:(b + 1) * RATE])
        state = permute(torch.cat([top, state[:, RATE:]], dim=1))
    return state[:, :out_words].contiguous()


def hash_pair(left, right):
    """2-to-1 compression of (M, 8) digests -> (M, 8)."""
    return hash_rows(torch.cat([left, right], dim=1))


def hash_tree(level):
    """The levels above an (M, 8) digest level, M a power of two: [(M/2, 8),
    ..., (1, 8)], node i of a level hashing nodes 2i and 2i + 1 below (the
    level loop of `merkle.commit`). Plain version of the CUDA tree top."""
    levels, cur = [], level
    while cur.shape[0] > 1:
        cur = hash_rows(cur.reshape(-1, 2 * DIGEST_WORDS))
        levels.append(cur)
    return levels

