"""Exact Baby Bear weighted column sum: CUDA kernel wrapper (`csrc/bbmm.cu`).

`weighted_sum(values, weights)` launches the hand-written kernel on CUDA
tensors: (M, K) int32 values, read in place row-major with any row
stride, and (K, W) int32 weights, W = 4 or 8 (one or two extension
elements: the widths the prover passes; any other width raises) -> (M, W)
int32, the sum of the Montgomery products (core/bbmm.py). CPU tensors are
refused: `core/bbmm` sends them to its plain version.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # cluster workers launch from threads
WIDTHS = (4, 8)  # csrc/bbmm.cu's instantiations


def _lib():
    lib = build.load("bt_bbmm", "bbmm.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bt_bbmm.argtypes = [vp, ll, vp, i, vp, ll, ctypes.c_uint, vp]
        lib.bt_bbmm.restype = i
        lib._bt_typed = True
    return lib


def row_stride(values: torch.Tensor) -> int:
    """The row stride ld with which the kernel reads the (M, K) `values`
    row-major (unit column stride; the column stride of K = 1 is never
    read). Raises on any other strides, a transposed view among them: the
    kernel copies nothing, and neither does this wrapper."""
    m, k = values.shape
    sm, sk = values.stride()
    if sk == 1 or k == 1:
        return sm
    raise ValueError(f"values strides {values.stride()} are not row-major "
                     f"(column stride must be 1)")


def weighted_sum(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, W) -> (M, W): the kernel on the card (see above)."""
    global LAUNCHES
    for t, name in ((values, "values"), (weights, "weights")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    if weights.device != values.device:
        raise ValueError(f"weights are on {weights.device}, values on "
                         f"{values.device}")
    m, k = values.shape
    if weights.shape[0] != k:
        raise ValueError(f"values {tuple(values.shape)} and weights "
                         f"{tuple(weights.shape)} do not contract")
    if k >= 1 << 32:
        raise ValueError(f"K = {k} exceeds the kernel's 32-bit column count")
    width = weights.shape[1]
    if width not in WIDTHS:
        raise ValueError(f"the kernel takes W in {WIDTHS}, got {width}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    ld = row_stride(values)
    out = torch.empty((m, width), dtype=torch.int32, device=values.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.bt_bbmm(values.data_ptr() if k else None, ld,
                         weights.data_ptr() if k else None, width,
                         out.data_ptr(), m, k, stream)
    if rc != 0:
        raise RuntimeError(f"weighted-sum launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
