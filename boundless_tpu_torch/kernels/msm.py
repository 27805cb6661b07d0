"""BN254 G1 Pippenger MSM: CUDA kernel wrapper (`csrc/msm.cu`).

`pippenger(points, prep)` sums the prepped entries (`groth16/msm_device.
prep`) over an (n, 16) int32 tensor of affine Montgomery points and
returns the (24,) Jacobian words of the result. It takes CUDA tensors
only and launches the kernel (four launches in one call: chunks, buckets,
bit slices, windows) or raises; the CPU route, the plain version
`msm_device.plain_pippenger`, is its caller's (`msm_device.msm`). There
is no fallback from the card to the plain or the host MSM.

`LAUNCHES` counts calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # cluster workers launch from threads


def _lib():
    lib = build.load("bt_msm", "msm.cu")
    if not getattr(lib, "_bt_typed", False):
        vp = ctypes.c_void_p
        lib.bt_msm_buckets.restype = ctypes.c_int
        lib.bt_msm_slices.restype = ctypes.c_int
        lib.bt_msm_run.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp,
                                   vp, vp, vp, vp, vp]
        lib.bt_msm_run.restype = ctypes.c_int
        lib._bt_typed = True
    return lib


def _check(x: torch.Tensor, name: str, dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pippenger(points: torch.Tensor, prep) -> torch.Tensor:
    """sum of the prepped entries -> (24,) int32 words (Jacobian X, Y, Z
    Montgomery limbs) on the points' device."""
    global LAUNCHES
    if points.dim() != 2 or points.shape[1] != 16:
        raise ValueError(f"points has shape {tuple(points.shape)}")
    args = (("points", points, torch.int32), ("idx", prep.idx, torch.int32),
            ("chunk_start", prep.chunk_start, torch.int64),
            ("chunk_len", prep.chunk_len, torch.int32),
            ("bucket_chunk0", prep.bucket_chunk0, torch.int64),
            ("bucket_chunks", prep.bucket_chunks, torch.int32))
    for name, x, dtype in args:
        _check(x, name, dtype)
        if x.device != points.device:
            raise ValueError(f"{name} is not on the points' device")
    lib = _lib()
    dev = points.device
    chunks = prep.chunk_start.shape[0]
    partial = torch.empty((max(chunks, 1), 24), dtype=torch.int32, device=dev)
    buckets = torch.empty((lib.bt_msm_buckets(), 24), dtype=torch.int32,
                          device=dev)
    slices = torch.empty((lib.bt_msm_slices(), 24), dtype=torch.int32,
                         device=dev)
    out = torch.empty(24, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bt_msm_run(
            points.data_ptr(), prep.idx.data_ptr(),
            prep.chunk_start.data_ptr(), prep.chunk_len.data_ptr(), chunks,
            prep.bucket_chunk0.data_ptr(), prep.bucket_chunks.data_ptr(),
            partial.data_ptr(), buckets.data_ptr(), slices.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"MSM launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
