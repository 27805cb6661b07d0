"""The p254 sponge: CUDA kernel wrapper (`csrc/poseidon254.cu`).

Every hash of the `poseidon254` suite's Merkle trees goes through this
module: leaves (`hash_rows`), tree levels and opened-path checks
(`hash_pairs`, `hash_level`). On a CUDA tensor each call launches the
hand-written kernel or raises; on a CPU tensor it runs the plain version,
the Python-int hash of `core/poseidon_bn254.py` (`hash_rows_np`,
`hash_pairs_np`). There is no fallback from the card to the plain version.

Digest words. A p254 digest is a 254-bit felt as 8 little-endian u32
words (`poseidon_bn254.digest_words`); words of 2^31 and above do not fit
the port's int32 storage of Baby Bear values. The port keeps them in int32
tensors as the u32 bit pattern: equality, gathers and `torch.where` see
the same words, and `words_np` reads them back as uint32.

`LAUNCHES` counts kernel launches (one per call that launched).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import field as F
from ..core import poseidon_bn254 as P254
from . import build

LAUNCHES = 0

_READY_DEVICES: set = set()


def _limbs(x: int) -> list:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def constant_tables():
    """(round constants (65 * 3 * 8,), MDS (3 * 3 * 8,)) as uint32 numpy:
    Montgomery form (R = 2^256) in 8 little-endian limbs a felt."""
    rcs, mds = P254.constants()
    mont = lambda v: _limbs(v * (1 << 256) % P254.FR)  # noqa: E731
    rc = np.asarray([mont(v) for row in rcs for v in row], dtype=np.uint32)
    md = np.asarray([mont(v) for row in mds for v in row], dtype=np.uint32)
    return rc.reshape(-1), md.reshape(-1)


def _lib():
    lib = build.load("bt_poseidon254", "poseidon254.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bt_p254_set_constants.argtypes = [vp, vp]
        lib.bt_p254_set_constants.restype = i
        lib.bt_p254_rows.argtypes = [vp, ctypes.c_longlong, i, vp, vp]
        lib.bt_p254_rows.restype = i
        lib.bt_p254_pairs.argtypes = [vp, ctypes.c_longlong, vp, vp]
        lib.bt_p254_pairs.restype = i
        lib._bt_typed = True
    return lib


def _ensure_constants(lib, device: torch.device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index in _READY_DEVICES:
        return
    rc, md = constant_tables()
    with torch.cuda.device(index):
        err = lib.bt_p254_set_constants(rc.ctypes.data, md.ctypes.data)
    if err != 0:
        raise RuntimeError(f"p254 constant upload failed: CUDA error {err}")
    _READY_DEVICES.add(index)


def _check(x: torch.Tensor, name: str, cols=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {x.dtype}")
    if x.dim() != 2 or (cols is not None and x.shape[1] != cols):
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


def _launch(call, device: torch.device):
    """Run `call(lib, stream)` (one kernel launch) on `device`."""
    global LAUNCHES
    lib = _lib()
    _ensure_constants(lib, device)
    with torch.cuda.device(device):
        err = call(lib, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"p254 sponge launch failed: CUDA error {err}")
    LAUNCHES += 1


def hash_rows(matrix):
    """Digest each row of (N, C) Montgomery int32 Baby Bear words -> (N, 8)
    digest words (int32 bit patterns)."""
    if matrix.device.type == "cpu":
        canon = F.from_mont(matrix).numpy().astype(np.uint32)
        return words_tensor(P254.hash_rows_np(canon), "cpu")
    matrix = matrix.contiguous()
    _check(matrix, "matrix")
    n, c = matrix.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=matrix.device)
    if n == 0:
        return out
    _launch(lambda lib, s: lib.bt_p254_rows(matrix.data_ptr(), n, c,
                                            out.data_ptr(), s), matrix.device)
    return out


def _check_canonical(pairs):
    """Raise ValueError unless every 8-word digest of `pairs` is a felt
    below r, on either device: the plain version asserts it
    (`poseidon_bn254.felt_of_words`), and the kernel, which would reduce
    such a word mod r, must refuse the same input (a proof's path
    siblings are untrusted)."""
    w = pairs.reshape(-1, 8).to(torch.int64) & 0xFFFFFFFF
    r = torch.tensor(_limbs(P254.FR), dtype=torch.int64, device=w.device)
    # the first nonzero sign from the top limb decides w < r
    weight = torch.tensor([1 << k for k in range(8)], dtype=torch.int64,
                          device=w.device)
    if not bool(((torch.sign(w - r) * weight).sum(-1) < 0).all()):
        raise ValueError("digest words out of field range")


def hash_level(pairs):
    """Pair hashes of an (M, 16) [left | right] digest-word matrix ->
    (M, 8): a Merkle level (the (M, 16) view of the level below). Raises
    ValueError on a digest of r or above."""
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
    _launch(lambda lib, s: lib.bt_p254_pairs(pairs.data_ptr(), m,
                                             out.data_ptr(), s), pairs.device)
    return out


def hash_pairs(left, right):
    """2-to-1 compression of (M, 8) digest pairs -> (M, 8)."""
    return hash_level(torch.cat([left, right], dim=1))
