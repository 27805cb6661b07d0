"""Poseidon permutation over the BN254 scalar field (the "p254" suite).

Role of risc0's Poseidon254/identity_p254 layer (reference:
`blake3_groth16/src/prove.rs:33-62` runs `identity_p254` so the final
STARK's Merkle/Fiat-Shamir hashing is BN254-native, making the Groth16
wrap circuit cheap — native-field Poseidon costs ~240 R1CS constraints
per permutation versus tens of thousands for an emulated Baby Bear
Poseidon2). Our final-shrink proof (`recursion/identity.py`) re-proves
the root recursion claim with THIS hash as the outer commitment suite;
the Groth16 verifier circuit (groth16/circuit.py) then re-derives every
hash natively.

Instance (our own deterministic parameter set, like core/poseidon2.py):

  * field: BN254 scalar field r (`FR`, groth16/bn254.py's R)
  * width t = 3 (rate 2, capacity 1), S-box x^5 (gcd(5, r-1) = 1)
  * R_F = 8 full rounds (4 + 4), R_P = 57 partial rounds
    (Poseidon-paper sizing for t = 3, alpha = 5, 128-bit security)
  * MDS: Cauchy matrix 1/(x_i + y_j) from nothing-up-my-sleeve x/y
  * round constants: SHA-256 counter mode

Baby Bear payloads pack 8 canonical 31-bit elements per felt
(little-endian 31-bit slots, 248 bits < 254); a Merkle digest is ONE
felt, represented on the wire as 8 little-endian u32 words so tree
shapes match the Poseidon2 suite exactly (core/merkle.py).

Counterpart of `boundless_tpu/core/poseidon_bn254.py`, copied: the
Python-int permutation and the numpy batch wrappers. On the card the
suite hashes through the CUDA sponge (`kernels/poseidon254.py`,
`csrc/poseidon254.cu`), which is held to `hash_rows_np` and
`hash_pairs_np` here (its plain version); the Fiat-Shamir transcript
(`core/suites.Transcript254`, a few permutations a proof) stays here.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Sequence, Tuple

import numpy as np

# the BN254 scalar field order r
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

T = 3
RATE = 2
ROUNDS_FULL = 8
ROUNDS_PARTIAL = 57
ALPHA = 5

PACK = 8  # Baby Bear elements per felt
PACK_BITS = 31
DIGEST_WORDS = 8  # 254-bit digest as 8 LE u32 words


def _nums(tag: bytes, count: int) -> List[int]:
    """Nothing-up-my-sleeve field elements (SHA-256 counter mode)."""
    out = []
    i = 0
    while len(out) < count:
        h = hashlib.sha256(
            b"boundless-tpu.poseidon.bn254.v1:" + tag + b":"
            + str(i).encode()).digest()
        v = int.from_bytes(h, "little") % FR
        out.append(v)
        i += 1
    return out


@functools.lru_cache(maxsize=1)
def constants() -> Tuple[tuple, tuple]:
    """(round_constants ((R_F+R_P) x 3), mds (3 x 3)), Python ints.

    The Cauchy MDS 1/(x_i + y_j) needs all x_i + y_j nonzero and the
    x_i (resp. y_j) pairwise distinct — guaranteed with overwhelming
    probability for hash-derived values; asserted anyway.
    """
    rc = _nums(b"rc", (ROUNDS_FULL + ROUNDS_PARTIAL) * T)
    rcs = tuple(tuple(rc[T * r : T * r + T])
                for r in range(ROUNDS_FULL + ROUNDS_PARTIAL))
    xs = _nums(b"mds-x", T)
    ys = _nums(b"mds-y", T)
    assert len(set(xs)) == T and len(set(ys)) == T
    mds = []
    for x in xs:
        row = []
        for y in ys:
            s = (x + y) % FR
            assert s != 0
            row.append(pow(s, FR - 2, FR))
        mds.append(tuple(row))
    return rcs, tuple(mds)


def _sbox(x: int) -> int:
    x2 = x * x % FR
    x4 = x2 * x2 % FR
    return x4 * x % FR


def permute(state: Sequence[int]) -> List[int]:
    """Poseidon permutation on 3 Python-int felts."""
    rcs, mds = constants()
    s = [int(x) % FR for x in state]
    assert len(s) == T
    half = ROUNDS_FULL // 2
    nrounds = ROUNDS_FULL + ROUNDS_PARTIAL

    for r in range(nrounds):
        s = [(s[i] + rcs[r][i]) % FR for i in range(T)]
        if half <= r < half + ROUNDS_PARTIAL:
            s[0] = _sbox(s[0])  # partial round
        else:
            s = [_sbox(x) for x in s]
        s = [sum(mds[i][j] * s[j] for j in range(T)) % FR for i in range(T)]
    return s


# ---------------------------------------------------------------------------
# Packing + sponge over Baby Bear payloads
# ---------------------------------------------------------------------------


def pack_bb(elems: Sequence[int]) -> int:
    """Up to PACK canonical Baby Bear elements -> one felt (LE 31-bit
    slots, zero-padded)."""
    assert len(elems) <= PACK
    acc = 0
    for i, e in enumerate(elems):
        e = int(e)
        assert 0 <= e < (1 << PACK_BITS)
        acc |= e << (PACK_BITS * i)
    return acc


def felts_of_bb(elems: Sequence[int]) -> List[int]:
    """Canonical Baby Bear vector -> felt vector (8 elems per felt)."""
    return [pack_bb(elems[i : i + PACK])
            for i in range(0, max(len(elems), 1), PACK)] or [0]


def digest_words(felt: int) -> Tuple[int, ...]:
    """felt -> 8 LE u32 words (the wire/Merkle-level digest form)."""
    return tuple((int(felt) >> (32 * i)) & 0xFFFFFFFF
                 for i in range(DIGEST_WORDS))


def felt_of_words(words: Sequence[int]) -> int:
    assert len(words) == DIGEST_WORDS
    acc = 0
    for i, w in enumerate(words):
        acc |= (int(w) & 0xFFFFFFFF) << (32 * i)
    assert acc < FR, "digest words out of field range"
    return acc


def hash_felts(felts: Sequence[int]) -> int:
    """Rate-2 sponge over felts (zero state, zero-padded final block).

    Mirrors poseidon2.hash_elems' shape: fixed-length inputs, absorb by
    field addition into the rate slots, digest = state[0].
    """
    fs = [int(x) % FR for x in felts]
    if not fs:
        fs = [0]
    if len(fs) % RATE:
        fs.append(0)
    s = [0, 0, 0]
    for i in range(0, len(fs), RATE):
        s[0] = (s[0] + fs[i]) % FR
        s[1] = (s[1] + fs[i + 1]) % FR
        s = permute(s)
    return s[0]


def hash_bb(elems: Sequence[int]) -> int:
    """Canonical Baby Bear vector -> felt digest."""
    return hash_felts(felts_of_bb([int(x) for x in elems]))


def hash_pair(a: int, b: int) -> int:
    """2-to-1 felt compression (one permutation)."""
    return permute([int(a) % FR, int(b) % FR, 0])[0]


# ---------------------------------------------------------------------------
# numpy batch wrappers (the sponge kernel's plain version)
# ---------------------------------------------------------------------------


def hash_rows_np(matrix: np.ndarray) -> np.ndarray:
    """(N, C) canonical u32 Baby Bear -> (N, 8) u32 digest words."""
    m = np.asarray(matrix, dtype=np.uint64)
    out = np.empty((m.shape[0], DIGEST_WORDS), dtype=np.uint32)
    for i in range(m.shape[0]):
        out[i] = digest_words(hash_bb([int(x) for x in m[i]]))
    return out


def hash_pairs_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(M, 8) + (M, 8) u32 digest words -> (M, 8)."""
    left = np.asarray(left)
    right = np.asarray(right)
    out = np.empty_like(left)
    for i in range(left.shape[0]):
        out[i] = digest_words(hash_pair(felt_of_words(left[i]),
                                        felt_of_words(right[i])))
    return out


# ---------------------------------------------------------------------------
# Challenge squeeze (Baby Bear challenges out of felt state)
# ---------------------------------------------------------------------------

BB_P = 2013265921
# 62-bit chunks mod P keep the sampling bias at ~2^-31 (a raw 31-bit
# chunk mod P would be ~3% biased). 4 chunks per 248-bit payload.
CHUNK_BITS = 62
CHUNKS_PER_FELT = 4


def squeeze_bb(felt: int) -> List[int]:
    """felt -> 4 canonical Baby Bear challenge elements."""
    out = []
    v = int(felt)
    for _ in range(CHUNKS_PER_FELT):
        out.append((v & ((1 << CHUNK_BITS) - 1)) % BB_P)
        v >>= CHUNK_BITS
    return out
