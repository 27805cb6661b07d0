"""The p254 sponge: CUDA kernel wrapper (`csrc/poseidon254.cu`).

Every hash of the `poseidon254` suite's Merkle trees goes through this
module: leaves (`hash_rows`), tree levels (`hash_level`, `hash_pairs`),
a tree's top levels (`hash_tree`) and opened paths (`hash_paths`). On a
CUDA tensor each call launches the hand-written kernel or raises; on a
CPU tensor it runs the plain version, the Python-int hash of
`core/poseidon_bn254.py` (`hash_rows_np`, `hash_pairs_np`). There is no
fallback from the card to the plain version.

Layouts. A launch of `LANE_CROSSOVER` rows or more runs one thread a hash
("lanes1"); a smaller one spreads each hash over 3 lanes of a warp
("lanes3"), which shortens a hash's chain where the card would idle.
`hash_tree` ("tree_top") hashes every level above a level of at most
`TREE_TOP` nodes in one block; `hash_paths` ("paths") walks whole opened
paths in one launch. The layout follows the shape, never a failure.

The kernel's permutation is the reference's in the sparse-matrix form of
the Poseidon paper (appendix B); `schedule_table` derives its constants
from `poseidon_bn254.constants()` exactly, mod r, and `permute_schedule`
is the same schedule in Python ints (held to `poseidon_bn254.permute` in
the tests).

Digest words. A p254 digest is a 254-bit felt as 8 little-endian u32
words (`poseidon_bn254.digest_words`); words of 2^31 and above do not fit
the port's int32 storage of Baby Bear values. The port keeps them in int32
tensors as the u32 bit pattern: equality, gathers and `torch.where` see
the same words, and `words_np` reads them back as uint32.

`LAUNCHES` counts kernel launches (one per call that launched),
`LAUNCHES_BY_LAYOUT` the same by layout.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..core import field as F
from ..core import poseidon_bn254 as P254
from . import build

LAUNCHES = 0
LAUNCHES_BY_LAYOUT = {"lanes1": 0, "lanes3": 0, "tree_top": 0, "paths": 0}
_COUNT_LOCK = threading.Lock()  # cluster workers launch from threads
# Launches of this many rows or more take one thread a hash, smaller ones
# 3 lanes a hash (tools/bn254_profile.py --sweep).
LANE_CROSSOVER = 1 << 14
TREE_TOP = 1 << 7  # csrc/poseidon254.cu TREE_TOP

_READY_DEVICES: set = set()
FR = P254.FR
HALF = P254.ROUNDS_FULL // 2
PARTIAL = P254.ROUNDS_PARTIAL


def _limbs(x: int) -> list:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


# ---------------------------------------------------------------------------
# the sparse-matrix schedule, exact mod r
# ---------------------------------------------------------------------------


def _matmul(a, b):
    return [[sum(a[i][k] * b[k][j] for k in range(len(b))) % FR
             for j in range(len(b[0]))] for i in range(len(a))]


def _matvec(a, v):
    return [sum(a[i][k] * v[k] for k in range(len(v))) % FR
            for i in range(len(a))]


def _inv3(m):
    """The inverse of a 3 x 3 matrix mod r (adjugate over determinant)."""
    c = [[(m[(j + 1) % 3][(i + 1) % 3] * m[(j + 2) % 3][(i + 2) % 3]
           - m[(j + 1) % 3][(i + 2) % 3] * m[(j + 2) % 3][(i + 1) % 3]) % FR
          for j in range(3)] for i in range(3)]
    det = sum(m[0][k] * c[k][0] for k in range(3)) % FR
    assert det, "singular matrix"
    inv = pow(det, FR - 2, FR)
    return [[x * inv % FR for x in row] for row in c]


def _inv2(m):
    det = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) % FR
    assert det, "singular matrix"
    inv = pow(det, FR - 2, FR)
    return [[m[1][1] * inv % FR, -m[0][1] * inv % FR],
            [-m[1][0] * inv % FR, m[0][0] * inv % FR]]


@functools.lru_cache(maxsize=1)
def schedule():
    """The kernel's round schedule as Python ints:

    full_rc (8, 3): the pre-S-box constants of full rounds 0..3, 61..64;
    post (3,): added after the S-boxes of round 3;
    k (57,): added to s0 after each partial round's S-box (k[56] = 0);
    mds (3, 3): M; pre (3, 3): round 3's matrix D_0 M;
    sparse (57, 3, 3): each partial round's matrix S_p as the lanes' rows:
    (n00, w1, w2), (n10, 1, 0), (n20, 0, 1).

    A partial round p of the reference is s <- M . sbox0(s + c_p).
    Constants: c_p, added after the matrix of round p - 1, is M u with
    u = M^-1 c_p; u's words 1 and 2 pass the partial S-box of round p - 1
    unchanged and join its constant, word 0 stays after that S-box as the
    scalar k[p - 1]; the first partial round's constant moves into round 3
    (a full round) as the vector `post`. Matrices: each partial round's
    matrix N = S D with D = diag(1, N^) (N^ its lower-right 2 x 2) and S =
    [[n00, (n01, n02) N^-1], [(n10, n20)^T, I]]; D commutes with the
    partial S-box and with k, so it moves into the round before: N_{p-1}
    = D_p M, and round 3's matrix becomes D_0 M."""
    rcs, mds = P254.constants()
    mds = [list(row) for row in mds]
    c = [list(row) for row in rcs]
    minv = _inv3(mds)
    k = [0] * PARTIAL
    for r in range(HALF + PARTIAL - 1, HALF, -1):
        u = _matvec(minv, c[r])
        k[r - 1 - HALF] = u[0]
        c[r - 1][1] = (c[r - 1][1] + u[1]) % FR
        c[r - 1][2] = (c[r - 1][2] + u[2]) % FR
    post = _matvec(minv, c[HALF])
    sparse = [None] * PARTIAL
    n = mds
    for p in range(PARTIAL - 1, -1, -1):
        hat = [row[1:] for row in n[1:]]
        w = _matvec([list(col) for col in zip(*_inv2(hat))], n[0][1:])
        sparse[p] = [[n[0][0], w[0], w[1]], [n[1][0], 1, 0], [n[2][0], 0, 1]]
        d = [[1, 0, 0], [0] + hat[0], [0] + hat[1]]
        n = _matmul(d, mds)
    full_rc = [c[r] for r in range(HALF)] + [
        c[r] for r in range(HALF + PARTIAL, 2 * HALF + PARTIAL)]
    return dict(full_rc=full_rc, post=post, k=k, mds=mds, pre=n,
                sparse=sparse)


def _sbox(x: int) -> int:
    return pow(x, P254.ALPHA, FR)


def permute_schedule(state):
    """The kernel's permutation in Python ints: equal to
    `poseidon_bn254.permute` for every state."""
    sc = schedule()
    s = [int(x) % FR for x in state]

    def full(r, mat, post=None):
        x = [_sbox(s[i] + sc["full_rc"][r][i]) for i in range(3)]
        if post is not None:
            x = [(x[i] + post[i]) % FR for i in range(3)]
        return _matvec(mat, x)

    for r in range(HALF):
        s = full(r, sc["pre"] if r == HALF - 1 else sc["mds"],
                 sc["post"] if r == HALF - 1 else None)
    for p in range(PARTIAL):
        x = (_sbox(s[0]) + sc["k"][p]) % FR
        s = _matvec(sc["sparse"][p], [x, s[1], s[2]])
    for r in range(HALF, 2 * HALF):
        s = full(r, sc["mds"])
    return s


def schedule_table() -> np.ndarray:
    """The kernel's constant table (csrc/poseidon254.cu TAB_*): full_rc,
    post, k, mds, pre, sparse, each felt in Montgomery form as 8
    little-endian u32 words."""
    sc = schedule()
    flat = ([v for row in sc["full_rc"] for v in row] + list(sc["post"])
            + list(sc["k"]) + [v for row in sc["mds"] for v in row]
            + [v for row in sc["pre"] for v in row]
            + [v for m in sc["sparse"] for row in m for v in row])
    return np.asarray([_limbs(v * (1 << 256) % FR) for v in flat],
                      dtype=np.uint32).reshape(-1)


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------


def _lib():
    lib = build.load("bt_poseidon254", "poseidon254.cu")
    if not getattr(lib, "_bt_typed", False):
        bind(lib)
        lib._bt_typed = True
    return lib


def bind(lib):
    """Set the C interface's argument types on a loaded library (the card's
    build or the tests' CPU emulation)."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("bt_p254_table_words", []), ("bt_p254_tree_top", []),
                       ("bt_p254_set_constants", [vp]),
                       ("bt_p254_rows", [vp, ll, i, i, vp, vp]),
                       ("bt_p254_pairs", [vp, ll, i, vp, vp]),
                       ("bt_p254_tree", [vp, i, vp, vp]),
                       ("bt_p254_paths", [vp, vp, vp, ll, i, vp, vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i


def _ensure_constants(lib, device: torch.device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index in _READY_DEVICES:
        return
    table = schedule_table()
    assert table.size == lib.bt_p254_table_words()
    assert lib.bt_p254_tree_top() == TREE_TOP
    with torch.cuda.device(index):
        err = lib.bt_p254_set_constants(table.ctypes.data)
    if err != 0:
        raise RuntimeError(f"p254 constant upload failed: CUDA error {err}")
    _READY_DEVICES.add(index)


def _check(x: torch.Tensor, name: str, cols=None, dtype=torch.int32):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if cols is not None and (x.dim() != 2 or x.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def words_np(x: torch.Tensor) -> np.ndarray:
    """Digest words (int32 bit patterns, any device) -> uint32 numpy."""
    return x.detach().cpu().numpy().astype(np.uint32)


def words_tensor(words, device) -> torch.Tensor:
    """u32 digest words (numpy or ints) -> int32 bit-pattern tensor."""
    arr = np.asarray(words, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def lanes_for(n: int) -> int:
    """Lanes a hash for a launch of `n` rows or pairs."""
    return 1 if n >= LANE_CROSSOVER else 3


def _launch(call, device: torch.device, layout: str):
    """Run `call(lib, stream)` (one kernel launch) on `device`."""
    global LAUNCHES
    lib = _lib()
    _ensure_constants(lib, device)
    with torch.cuda.device(device):
        err = call(lib, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p254 sponge launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_LAYOUT[layout] += 1


def hash_rows(matrix):
    """Digest each row of (N, C) Montgomery int32 Baby Bear words -> (N, 8)
    digest words (int32 bit patterns)."""
    return _hash_rows(matrix, lanes_for(matrix.shape[0]))


def _hash_rows(matrix, lanes: int):
    """hash_rows at `lanes` (1 or 3) a hash on the card: the layout forced,
    for checks and timings."""
    if matrix.device.type == "cpu":
        canon = F.from_mont(matrix).numpy().astype(np.uint32)
        return words_tensor(P254.hash_rows_np(canon), "cpu")
    matrix = matrix.contiguous()
    _check(matrix, "matrix")
    if matrix.dim() != 2:
        raise ValueError(f"matrix has shape {tuple(matrix.shape)}")
    n, c = matrix.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=matrix.device)
    if n == 0:
        return out
    _launch(lambda lib, s: lib.bt_p254_rows(matrix.data_ptr(), n, c, lanes,
                                            out.data_ptr(), s),
            matrix.device, f"lanes{lanes}")
    return out


def _check_canonical(digests):
    """Raise ValueError unless every 8-word digest of `digests` is a felt
    below r, on either device: the plain version asserts it
    (`poseidon_bn254.felt_of_words`), and the kernel, which would reduce
    such a word mod r, must refuse the same input (a proof's path
    siblings are untrusted)."""
    w = digests.reshape(-1, 8).to(torch.int64) & 0xFFFFFFFF
    r = torch.tensor(_limbs(FR), dtype=torch.int64, device=w.device)
    # the first nonzero sign from the top limb decides w < r
    weight = torch.tensor([1 << k for k in range(8)], dtype=torch.int64,
                          device=w.device)
    if not bool(((torch.sign(w - r) * weight).sum(-1) < 0).all()):
        raise ValueError("digest words out of field range")


def hash_level(pairs, trusted=False):
    """Pair hashes of an (M, 16) [left | right] digest-word matrix ->
    (M, 8): a Merkle level (the (M, 16) view of the level below). Raises
    ValueError on a digest of r or above, unless the caller made every
    digest itself (`trusted`: a commit's own levels; the check costs the
    host a synchronize)."""
    return _hash_level(pairs, lanes_for(pairs.shape[0]), trusted)


def _hash_level(pairs, lanes: int, trusted=False):
    """hash_level at `lanes` (1 or 3) a hash on the card: the layout
    forced, for checks and timings."""
    if not trusted:
        _check_canonical(pairs)
    if pairs.device.type == "cpu":
        w = words_np(pairs)
        return words_tensor(P254.hash_pairs_np(w[:, :8], w[:, 8:]), "cpu")
    pairs = pairs.contiguous()
    _check(pairs, "pairs", 16)
    m = pairs.shape[0]
    out = torch.empty((m, 8), dtype=torch.int32, device=pairs.device)
    if m == 0:
        return out
    _launch(lambda lib, s: lib.bt_p254_pairs(pairs.data_ptr(), m, lanes,
                                             out.data_ptr(), s),
            pairs.device, f"lanes{lanes}")
    return out


def hash_pairs(left, right):
    """2-to-1 compression of (M, 8) digest pairs -> (M, 8)."""
    return hash_level(torch.cat([left, right], dim=1))


def hash_tree(level):
    """Every level above an (m, 8) level of digests, m a power of two with
    2 <= m <= TREE_TOP, lowest first: [(m/2, 8), ..., (1, 8)]; one launch
    on the card. The level's digests are the tree's own (canonical)."""
    m = level.shape[0]
    if m < 2 or m > TREE_TOP or m & (m - 1):
        raise ValueError(f"hash_tree takes 2 .. {TREE_TOP} nodes (a power "
                         f"of two), got {m}")
    sizes = [m >> d for d in range(1, m.bit_length())]
    if level.device.type == "cpu":
        out, cur = [], level
        for _ in sizes:
            cur = hash_level(cur.reshape(-1, 16), trusted=True)
            out.append(cur)
        return out
    level = level.contiguous()
    _check(level, "level", 8)
    flat = torch.empty((m - 1, 8), dtype=torch.int32, device=level.device)
    _launch(lambda lib, s: lib.bt_p254_tree(level.data_ptr(), m,
                                            flat.data_ptr(), s),
            level.device, "tree_top")
    return list(torch.split(flat, sizes))


def hash_paths(leaves, indices, paths):
    """The roots of opened paths: leaf digests (Q, 8), leaf indices (Q,),
    sibling digests (Q, D, 8) -> (Q, 8); one launch on the card. Raises
    ValueError on a sibling of r or above (the siblings are untrusted)."""
    _check_canonical(paths)
    q, depth = paths.shape[0], paths.shape[1]
    if depth == 0 or q == 0:
        return leaves.clone()
    if leaves.device.type == "cpu":
        cur, idx = leaves, indices
        for d in range(depth):
            sib = paths[:, d]
            right = (idx & 1).bool()[:, None]
            cur = hash_pairs(torch.where(right, sib, cur),
                             torch.where(right, cur, sib))
            idx = idx >> 1
        return cur
    leaves = leaves.contiguous()
    paths = paths.contiguous()
    idx = indices.to(torch.int64).contiguous()
    _check(leaves, "leaves", 8)
    _check(paths.view(q, -1), "paths", 8 * depth)
    _check(idx, "indices", dtype=torch.int64)
    if idx.shape != (q,) or leaves.shape[0] != q:
        raise ValueError("leaves, indices and paths disagree on the count")
    out = torch.empty((q, 8), dtype=torch.int32, device=leaves.device)
    _launch(lambda lib, s: lib.bt_p254_paths(
        leaves.data_ptr(), idx.data_ptr(), paths.data_ptr(), q, depth,
        out.data_ptr(), s), leaves.device, "paths")
    return out
