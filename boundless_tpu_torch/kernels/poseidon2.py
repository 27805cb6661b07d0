"""Poseidon2 sponge: CUDA kernel wrapper (`csrc/poseidon2.cu`).

Every hash of the prover goes through this module: Merkle leaves and tree
levels (`core/merkle.py`), opened-path checks (`merkle.verify_rows`) and
the Fiat-Shamir transcript (`core/transcript.py`). On a CUDA tensor each
call launches the hand-written kernel or raises; on a CPU tensor it runs
the plain torch version (`core/poseidon2.py`). There is no fallback from
the card to the plain version.

Layouts. `hash_rows`, `hash_pairs` and `permute` hash each row with one
thread, or with a group of 2, 4 or 8 lanes of a warp that split the
24-word state into whole M4 chunks (`lanes_for`): one thread a hash fills
the card from `LANE_CROSSOVER[0][0]` rows up, and below that the lanes
give a launch of few rows G times the warps. `hash_tree` hashes the levels
above a level of at most `tree_max()` nodes in one launch of one block
(`merkle.commit` calls it once a level has at most `TREE_TOP` nodes).
`_sponge(..., lanes)` forces a layout, for checks and timings.

`LAUNCHES` counts kernel launches (one per call that launched);
`LAUNCHES_BY_LAYOUT` splits them by layout ("lanes1", "lanes2", "lanes4",
"lanes8", "tree_top").
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import poseidon2 as P2
from . import build

LANES = (1, 2, 4, 8)  # the layouts: lanes a hash
# (fewest rows, lanes a hash), first match wins; fewer rows take 8 lanes.
# Measured by chip_smoke.py ([sweep]) on an H100 (700 W): one thread a
# hash is the fastest from 2^15 rows (1,024 warps, about two a scheduler),
# 2 lanes from 2^13, 8 lanes below; 4 lanes never leads by more than 1%
# (the tree top uses it).
LANE_CROSSOVER = ((1 << 15, 1), (1 << 13, 2))
# merkle.commit hashes one launch a level down to a level of at most
# TREE_TOP nodes and the rest in one `hash_tree` launch. The tree top runs
# on one SM: up to 128 nodes it takes no more device time than the level
# loop and half its host time (chip_smoke.py [sweep], H100 700 W);
# above that its device time grows past the loop's.
TREE_TOP = 1 << 7

LAUNCHES = 0
LAUNCHES_BY_LAYOUT = {f"lanes{g}": 0 for g in LANES} | {"tree_top": 0}

_READY_DEVICES: set = set()


def _lib():
    lib = build.load("bt_poseidon2", "poseidon2.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bt_p2_set_constants.argtypes = [vp, vp, vp]
        lib.bt_p2_set_constants.restype = i
        lib.bt_p2_sponge.argtypes = [vp, ctypes.c_longlong, i, i, vp, vp, i,
                                     i, vp]
        lib.bt_p2_sponge.restype = i
        lib.bt_p2_tree.argtypes = [vp, i, vp, vp]
        lib.bt_p2_tree.restype = i
        lib.bt_p2_tree_max.restype = i
        lib._bt_typed = True
    return lib


def _ensure_constants(lib, device: torch.device):
    """Upload the round constants to `device`'s constant memory once."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index in _READY_DEVICES:
        return
    tables = [np.ascontiguousarray(t, dtype=np.uint32)
              for t in P2.constants()]
    with torch.cuda.device(index):
        rc = lib.bt_p2_set_constants(*(t.ctypes.data for t in tables))
    if rc != 0:
        raise RuntimeError(f"Poseidon2 constant upload failed: CUDA error {rc}")
    _READY_DEVICES.add(index)


def _check(x: torch.Tensor, name: str, cols=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 Montgomery words, got {x.dtype}")
    if x.dim() != 2 or (cols is not None and x.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lanes_for(n: int) -> int:
    """Lanes a hash for a launch of `n` rows (`LANE_CROSSOVER`)."""
    for fewest, lanes in LANE_CROSSOVER:
        if n >= fewest:
            return lanes
    return LANES[-1]


def _count(layout: str):
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_LAYOUT[layout] += 1


def _sponge(matrix, init, out_words: int, lanes=None):
    _check(matrix, "matrix")
    n, c = matrix.shape
    if init is not None:
        _check(init, "init", P2.WIDTH)
        if init.shape[0] != n or init.device != matrix.device:
            raise ValueError("init must be (N, 24) on the matrix's device")
    lanes = lanes_for(n) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    out = torch.empty((n, out_words), dtype=torch.int32, device=matrix.device)
    if n == 0:
        return out
    lib = _lib()
    _ensure_constants(lib, matrix.device)
    vec4 = int(c % 4 == 0 and matrix.data_ptr() % 16 == 0)
    with torch.cuda.device(matrix.device):
        stream = torch.cuda.current_stream(matrix.device).cuda_stream
        rc = lib.bt_p2_sponge(matrix.data_ptr(), n, c, vec4,
                              init.data_ptr() if init is not None else None,
                              out.data_ptr(), out_words, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"Poseidon2 sponge launch failed: CUDA error {rc}")
    _count(f"lanes{lanes}")
    return out


def hash_rows(matrix):
    """Sponge-hash each row of (N, C) Montgomery int32 -> (N, 8)."""
    if matrix.device.type == "cpu":
        return P2.hash_rows(matrix)
    return _sponge(matrix, None, P2.DIGEST_WORDS)


def hash_pairs(left, right):
    """2-to-1 compression of (M, 8) digest pairs -> (M, 8)."""
    return hash_rows(torch.cat([left, right], dim=1))


def permute(states):
    """One Poseidon2 permutation of each (N, 24) state (the sponge with
    an initial state and no input columns)."""
    if states.device.type == "cpu":
        return P2.permute(states)
    empty = torch.empty((states.shape[0], 0), dtype=torch.int32,
                        device=states.device)
    return _sponge(empty, states.contiguous(), P2.WIDTH)


def tree_max() -> int:
    """Nodes of the largest level `hash_tree` takes on the card."""
    return _lib().bt_p2_tree_max()


def hash_tree(level):
    """The levels above an (M, 8) digest level, M a power of two:
    [(M/2, 8), (M/4, 8), ..., (1, 8)] (the level loop of `merkle.commit`).
    On the card one launch of one block, M <= tree_max()."""
    if level.device.type == "cpu":
        return P2.hash_tree(level)
    _check(level, "level", P2.DIGEST_WORDS)
    m = level.shape[0]
    lib = _lib()
    if m < 2 or m > lib.bt_p2_tree_max() or m & (m - 1):
        raise ValueError(f"a tree top takes a power of two in "
                         f"[2, {lib.bt_p2_tree_max()}] nodes, got {m}")
    out = torch.empty((m - 1, P2.DIGEST_WORDS), dtype=torch.int32,
                      device=level.device)
    _ensure_constants(lib, level.device)
    with torch.cuda.device(level.device):
        stream = torch.cuda.current_stream(level.device).cuda_stream
        rc = lib.bt_p2_tree(level.data_ptr(), m, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"Poseidon2 tree-top launch failed: CUDA error {rc}")
    _count("tree_top")
    levels, start = [], 0
    h = m // 2
    while h >= 1:
        levels.append(out[start:start + h])
        start, h = start + h, h // 2
    return levels
