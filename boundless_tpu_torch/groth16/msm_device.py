"""BN254 G1 MSM on the card: host prep, point conversion, the plain version.

Counterpart of `boundless_tpu/groth16/msm_tpu.py`'s Pippenger
(`msm_pippenger` :237). `msm(points, scalars, device)` computes
sum_i s_i P_i with 8-bit signed windows (32 windows x 128 buckets):

  * points: `device_points` converts a list of G1 to an (n, 16) int32
    tensor of affine Montgomery limbs (`groth16/limbs.py`; x then y, u32
    bit patterns, (0, 0) at infinity) once, with one batched inversion,
    and caches it for the list (a ProvingKey's point lists are converted
    once and stay on the card; the reference converts on every call);
  * `prep`: each scalar's 32 little-endian bytes recoded into signed
    digits in [-127, 128] (`signed_digits`: a byte above 128 becomes byte
    - 256 and carries one into the next window; r's top byte is 0x30, so
    window 31 never carries out). In torch on the card: zero digits
    dropped, each entry's point index bitwise negated for a negative
    digit (the kernel negates y), entries sorted by bucket (window * 128
    + |d| - 1), each bucket's list cut into chunks of `chunk_for(E)`
    entries (`sort`, `bincount`, `cumsum`);
  * the curve arithmetic runs in `kernels/msm.py` (`csrc/msm.cu`) on a
    CUDA tensor, and in `plain_pippenger` here on a CPU tensor.

`plain_pippenger` is the kernel's plain version: the same prep and plain
torch limb products (`limbs.mul`: int64, one reduction a product). It sums
each chunk and then each bucket with branchless Jacobian additions
(`ec_add`, the reference's :92 selects) vectorized over chunks and
buckets, reduces each window as sum_b 2^b (sum of the buckets whose |d|
has bit b), and joins the 32 windows on the host (Python ints). The
kernel does the last two steps in two launches (`csrc/msm.cu`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import limbs as LB
from .bn254 import G1, P as Q_INT, R

WINDOW_BITS = 8
WINDOWS = 32  # ceil(254 / 8)
BUCKETS = 1 << (WINDOW_BITS - 1)  # |d| = 1 .. 128
CHUNK = 32  # the fewest entries a thread sums before the bucket pass
# the most chunks a bucket's thread adds, where the entries allow
BUCKET_CHUNKS = 64


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------


def affine_batch(points: Sequence[G1]) -> List[Optional[tuple]]:
    """Jacobian G1 points -> affine (x, y) ints (None at infinity), with
    one modular inversion for the whole list."""
    zs = [p.z % Q_INT for p in points]
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        if z:
            acc = acc * z % Q_INT
    inv = pow(acc, Q_INT - 2, Q_INT)
    out: List[Optional[tuple]] = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        z = zs[i]
        if not z:
            continue
        zi = prefix[i] * inv % Q_INT
        inv = inv * z % Q_INT
        zi2 = zi * zi % Q_INT
        p = points[i]
        out[i] = (p.x * zi2 % Q_INT, p.y * zi2 * zi % Q_INT)
    return out


def points_words(points: Sequence[G1]) -> np.ndarray:
    """List[G1] -> (n, 16) uint32 affine Montgomery limbs (zeros at
    infinity)."""
    blob = bytearray()
    zero = bytes(64)
    for aff in affine_batch(points):
        if aff is None:
            blob += zero
        else:
            blob += (aff[0] * LB.R_MOD_N % Q_INT).to_bytes(32, "little")
            blob += (aff[1] * LB.R_MOD_N % Q_INT).to_bytes(32, "little")
    return np.frombuffer(bytes(blob), dtype=np.uint32).reshape(-1, 16)


_POINT_CACHE: dict = {}
_POINT_CACHE_MAX = 4  # a ProvingKey's four G1 lists


def device_points(points: Sequence[G1], device) -> torch.Tensor:
    """The (n, 16) int32 point tensor of `points` on `device`, built once
    per list object (the cache holds the list, so its id stays valid)."""
    key = (id(points), str(device))
    hit = _POINT_CACHE.get(key)
    if hit is not None and hit[0] is points and len(points) == hit[1].shape[0]:
        return hit[1]
    words = points_words(points)
    t = torch.from_numpy(words.view(np.int32).copy()).to(device)
    if len(_POINT_CACHE) >= _POINT_CACHE_MAX:
        _POINT_CACHE.pop(next(iter(_POINT_CACHE)))
    _POINT_CACHE[key] = (points, t)
    return t


def point_from_words(words) -> G1:
    """24 u32 words (Jacobian X, Y, Z Montgomery limbs) -> G1."""
    w = np.asarray(words, dtype=np.int64).astype(np.uint32)
    x, y, z = (LB.from_mont(w[8 * k: 8 * k + 8]) for k in range(3))
    return G1.infinity() if z == 0 else G1(x, y, z)


def point_words(p: G1) -> np.ndarray:
    """G1 -> 24 u32 words (Jacobian Montgomery limbs; zeros at infinity)."""
    if p.is_infinity():
        return np.zeros(24, dtype=np.uint32)
    return np.concatenate([LB.to_mont(p.x % Q_INT), LB.to_mont(p.y % Q_INT),
                           LB.to_mont(p.z % Q_INT)])


# ---------------------------------------------------------------------------
# prep (torch glue on the points' device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Prep:
    # (E,) int32 point index i of each sorted entry, ~i (< 0) for a
    # negative digit
    idx: torch.Tensor
    chunk_start: torch.Tensor  # (C,) int64
    chunk_len: torch.Tensor  # (C,) int32
    bucket_chunk0: torch.Tensor  # (WINDOWS * BUCKETS,) int64
    bucket_chunks: torch.Tensor  # (WINDOWS * BUCKETS,) int32


def digits(scalars: Sequence[int], device) -> torch.Tensor:
    """(n, 32) uint8: byte j of s_i mod R."""
    blob = b"".join((int(s) % R).to_bytes(32, "little") for s in scalars)
    return torch.frombuffer(bytearray(blob), dtype=torch.uint8).view(
        -1, WINDOWS).to(device)


def signed_digits(scalars: Sequence[int], device) -> torch.Tensor:
    """(n, 32) int64 digits d in [-127, 128] with sum_w d_w 256^w = s_i
    mod R: a byte (plus the carry in) above 128 becomes it - 256 and
    carries one into the next window. Window 31 never carries out: its
    byte is at most 0x30 (R < 0x31 * 2^248)."""
    d = digits(scalars, device).to(torch.int64)
    carry = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    out = torch.empty_like(d)
    for w in range(WINDOWS):
        v = d[:, w] + carry
        carry = (v > BUCKETS).to(torch.int64)
        out[:, w] = v - (carry << WINDOW_BITS)
    return out


def chunk_for(entries: int) -> int:
    """Entries a chunk: CHUNK, or more where the buckets would otherwise
    hold over BUCKET_CHUNKS chunks on average (a bucket's thread chains
    its chunks)."""
    mean = -(-entries // (WINDOWS * BUCKETS))
    return max(CHUNK, -(-mean // BUCKET_CHUNKS))


def prep(scalars: Sequence[int], device) -> Prep:
    d = signed_digits(scalars, device)
    n = d.shape[0]
    mag = d.abs()
    keys = (mag - 1 + torch.arange(WINDOWS, device=device) * BUCKETS
            ).reshape(-1)
    point = torch.arange(n, device=device).repeat_interleave(WINDOWS)
    signed = torch.where(d.reshape(-1) < 0, ~point, point)
    nz = mag.reshape(-1) != 0
    keys, order = torch.sort(keys[nz], stable=True)
    idx = signed[nz][order].to(torch.int32)
    counts = torch.bincount(keys, minlength=WINDOWS * BUCKETS)
    chunk = chunk_for(idx.shape[0])
    start = torch.cumsum(counts, 0) - counts
    nch = (counts + chunk - 1) // chunk
    chunk0 = torch.cumsum(nch, 0) - nch
    bucket = torch.repeat_interleave(
        torch.arange(WINDOWS * BUCKETS, device=device), nch)
    j = torch.arange(bucket.shape[0], device=device) - chunk0[bucket]
    chunk_start = start[bucket] + j * chunk
    chunk_len = torch.minimum(counts[bucket] - j * chunk,
                              torch.full_like(j, chunk))
    return Prep(idx=idx, chunk_start=chunk_start,
                chunk_len=chunk_len.to(torch.int32), bucket_chunk0=chunk0,
                bucket_chunks=nch.to(torch.int32))


# ---------------------------------------------------------------------------
# the plain version: branchless Jacobian arithmetic on (..., 3, 8) limbs
# ---------------------------------------------------------------------------


def _one(device):
    return LB.tensor(LB.to_mont(1), device)


def _is_inf(p):
    return LB.is_zero(p[..., 2, :])


def ec_double(p):
    """Jacobian doubling (dbl-2009-l, a = 0); infinity stays (Z = 0)."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    A = LB.mul(X, X)
    Bv = LB.mul(Y, Y)
    C = LB.mul(Bv, Bv)
    t = LB.add(X, Bv)
    D = LB.sub(LB.mul(t, t), LB.add(A, C))
    D = LB.add(D, D)
    E = LB.add(LB.add(A, A), A)
    F = LB.mul(E, E)
    X3 = LB.sub(F, LB.add(D, D))
    C8 = LB.add(C, C)
    C8 = LB.add(C8, C8)
    C8 = LB.add(C8, C8)
    Y3 = LB.sub(LB.mul(E, LB.sub(D, X3)), C8)
    YZ = LB.mul(Y, Z)
    return torch.stack([X3, Y3, LB.add(YZ, YZ)], dim=-2)


def ec_add(p, q):
    """Branchless Jacobian addition covering the infinity, doubling and
    negation cases by selects (the reference's `msm_tpu.ec_add`)."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    Z1Z1 = LB.mul(Z1, Z1)
    Z2Z2 = LB.mul(Z2, Z2)
    U1 = LB.mul(X1, Z2Z2)
    U2 = LB.mul(X2, Z1Z1)
    S1 = LB.mul(LB.mul(Y1, Z2), Z2Z2)
    S2 = LB.mul(LB.mul(Y2, Z1), Z1Z1)
    H = LB.sub(U2, U1)
    r = LB.sub(S2, S1)
    r = LB.add(r, r)
    I = LB.mul(H, H)
    I = LB.add(LB.add(I, I), LB.add(I, I))
    J = LB.mul(H, I)
    V = LB.mul(U1, I)
    X3 = LB.sub(LB.sub(LB.mul(r, r), J), LB.add(V, V))
    S1J = LB.mul(S1, J)
    Y3 = LB.sub(LB.mul(r, LB.sub(V, X3)), LB.add(S1J, S1J))
    ZZ = LB.mul(Z1, Z2)
    Z3 = LB.mul(LB.add(ZZ, ZZ), H)
    out = torch.stack([X3, Y3, Z3], dim=-2)
    same_x = LB.eq(U1, U2)
    same_y = LB.eq(S1, S2)
    sel = lambda m, a, b: torch.where(m[..., None, None], a, b)  # noqa: E731
    out = sel(same_x & same_y, ec_double(p), out)
    out = sel(same_x & ~same_y, torch.zeros_like(p), out)
    out = sel(_is_inf(q), p, out)
    return sel(_is_inf(p), q, out)


def _jacobian(points: torch.Tensor) -> torch.Tensor:
    """(n, 16) int32 affine words -> (n, 3, 8) int64 Jacobian limbs."""
    w = points.to(torch.int64) & 0xFFFFFFFF
    x, y = w[:, :8], w[:, 8:]
    inf = LB.is_zero(x) & LB.is_zero(y)
    z = torch.where(inf[:, None], torch.zeros_like(x),
                    _one(points.device).expand_as(x))
    return torch.stack([x, y, z], dim=1)


def _masked_sum(acc, items, count, start):
    """acc[k] += items[start[k] + s] for s < count[k], one step at a time
    across every row k."""
    steps = int(count.max()) if count.numel() else 0
    for s in range(steps):
        live = s < count
        pos = torch.where(live, start + s, torch.zeros_like(start))
        nxt = items[pos]
        acc = torch.where(live[:, None, None], ec_add(acc, nxt), acc)
    return acc


def _entries(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(E, 3, 8) Jacobian limbs of the signed entries: the point ~i with y
    negated (q - y) where the index is negative."""
    pts = _jacobian(points)
    i = idx.to(torch.int64)
    neg = i < 0
    ent = pts[torch.where(neg, ~i, i)]
    y = ent[:, 1]
    ent[:, 1] = torch.where(neg[:, None], LB.sub(torch.zeros_like(y), y), y)
    return ent


def plain_windows(points: torch.Tensor, pr: Prep) -> torch.Tensor:
    """Each window's sum_d d * B_d as (WINDOWS, 3, 8) Jacobian limbs."""
    dev = points.device
    ent = _entries(points, pr.idx)
    nchunks = pr.chunk_start.shape[0]
    inf = torch.zeros((nchunks, 3, LB.L), dtype=torch.int64, device=dev)
    partial = _masked_sum(inf, ent, pr.chunk_len.to(torch.int64),
                          pr.chunk_start)
    binf = torch.zeros((WINDOWS * BUCKETS, 3, LB.L), dtype=torch.int64,
                       device=dev)
    buckets = _masked_sum(binf, partial, pr.bucket_chunks.to(torch.int64),
                          pr.bucket_chunk0)
    # bucket |d| - 1 = 0 .. 127, and an infinity at 128 to pad the slices
    buckets = torch.cat([buckets.view(WINDOWS, BUCKETS, 3, LB.L),
                         torch.zeros((WINDOWS, 1, 3, LB.L), dtype=torch.int64,
                                     device=dev)], dim=1)
    # sum_d d * B_d = sum_b 2^b * (sum of the B_d whose |d| has bit b)
    d = torch.arange(1, BUCKETS + 1, device=dev)
    half = BUCKETS // 2
    sel = []
    for b in range(WINDOW_BITS):
        members = d[(d >> b) & 1 == 1] - 1
        pad = torch.full((half - members.shape[0],), BUCKETS, device=dev)
        sel.append(torch.cat([members, pad]))
    s = buckets[:, torch.stack(sel)]  # (WINDOWS, bits, 64, 3, 8)
    while s.shape[2] > 1:
        h = s.shape[2] // 2
        s = ec_add(s[:, :, :h], s[:, :, h:])
    s = s[:, :, 0]
    acc = s[:, WINDOW_BITS - 1]
    for b in range(WINDOW_BITS - 2, -1, -1):
        acc = ec_add(ec_double(acc), s[:, b])
    return acc


def plain_pippenger(points: torch.Tensor, pr: Prep) -> torch.Tensor:
    """The plain version of the kernel: (24,) int64 words of the sum (the
    32 windows joined on the host)."""
    wins = plain_windows(points, pr).reshape(WINDOWS, 24).cpu().numpy()
    acc = G1.infinity()
    for j in range(WINDOWS - 1, -1, -1):
        for _ in range(WINDOW_BITS):
            acc = acc.double()
        acc = acc.add(point_from_words(wins[j]))
    return torch.from_numpy(point_words(acc).astype(np.int64))


def msm(points: Sequence[G1], scalars: Sequence[int], device) -> G1:
    """sum_i s_i P_i on `device`: the CUDA Pippenger on the card, the plain
    version on the CPU."""
    from ..kernels import msm as MK

    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    if len(points) == 0:
        return G1.infinity()
    pts = device_points(points, device)
    return point_from_words(MK.pippenger(pts, prep(scalars, device))
                            .cpu().numpy())
