"""Poseidon2 sponge: CUDA kernel wrapper (`csrc/poseidon2.cu`).

Every hash of the prover goes through this module: Merkle leaves and tree
levels (`core/merkle.py`), opened-path checks (`merkle.verify_rows`) and
the Fiat-Shamir transcript (`core/transcript.py`). On a CUDA tensor each
call launches the hand-written sponge kernel or raises; on a CPU tensor it
runs the plain torch sponge (`core/poseidon2.py`). There is no fallback
from the card to the plain version.

`LAUNCHES` counts kernel launches (one per call that launched).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import poseidon2 as P2
from . import build

LAUNCHES = 0

_READY_DEVICES: set = set()


def _lib():
    lib = build.load("bt_poseidon2", "poseidon2.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bt_p2_set_constants.argtypes = [vp, vp, vp]
        lib.bt_p2_set_constants.restype = i
        lib.bt_p2_sponge.argtypes = [vp, ctypes.c_longlong, i, vp, vp, i, vp]
        lib.bt_p2_sponge.restype = i
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


def _sponge(matrix, init, out_words: int):
    global LAUNCHES
    _check(matrix, "matrix")
    n, c = matrix.shape
    if init is not None:
        _check(init, "init", P2.WIDTH)
        if init.shape[0] != n or init.device != matrix.device:
            raise ValueError("init must be (N, 24) on the matrix's device")
    out = torch.empty((n, out_words), dtype=torch.int32, device=matrix.device)
    if n == 0:
        return out
    lib = _lib()
    _ensure_constants(lib, matrix.device)
    with torch.cuda.device(matrix.device):
        stream = torch.cuda.current_stream(matrix.device).cuda_stream
        rc = lib.bt_p2_sponge(matrix.data_ptr(), n, c,
                              init.data_ptr() if init is not None else None,
                              out.data_ptr(), out_words, stream)
    if rc != 0:
        raise RuntimeError(f"Poseidon2 sponge launch failed: CUDA error {rc}")
    LAUNCHES += 1
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
