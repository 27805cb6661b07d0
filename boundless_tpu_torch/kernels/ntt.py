"""NTT sub-transform: CUDA kernel wrapper (`csrc/ntt.cu`).

`sub_ntt` runs the size-m NTT along axis 0 of an (m, lanes) Montgomery
int32 tile, optionally multiplying by a four-step mid-twiddle table and
storing the result transposed (see `core/ntt.ntt_four_step`). On a CUDA
tensor each call launches the hand-written kernel or raises; on a CPU
tensor it runs `sub_ntt_plain`, the same function in plain torch (the
port's Stockham stages, then the twiddle multiply and the transpose).
There is no fallback from the card to the plain version.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import field as F
from ..core import ntt as NTT
from . import build

LAUNCHES = 0
MAX_LOG_M = 10  # csrc/ntt.cu MAX_LOG_M: two (1024, 16) buffers in 132 KB
MAX_M = 1 << MAX_LOG_M


def _lib():
    lib = build.load("bt_ntt", "ntt.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.bt_ntt_sub.argtypes = [vp, vp, vp, i, u, vp, u, u, vp]
        lib.bt_ntt_sub.restype = i
        lib.bt_ntt_max_log_m.argtypes, lib.bt_ntt_max_log_m.restype = [], i
        if lib.bt_ntt_max_log_m() != MAX_LOG_M:
            raise RuntimeError("csrc/ntt.cu and kernels/ntt.py disagree on "
                               "the largest sub-transform")
        lib._bt_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _flat_twiddles(m: int, forward: bool) -> np.ndarray:
    """The m - 1 stage twiddles of a size-m NTT in one (m,) int32 row:
    stage t's 2^t words at offset 2^t (word 0 unused)."""
    return np.concatenate([np.zeros(1, np.int32)]
                          + list(NTT._stage_twiddles(m, forward)))


@functools.lru_cache(maxsize=None)
def _device_twiddles(m: int, forward: bool, device) -> torch.Tensor:
    return torch.from_numpy(_flat_twiddles(m, forward)).to(device)


def sub_ntt_plain(x, forward: bool, mid=None):
    """Plain torch version of the kernel: the Stockham NTT along axis 0;
    with `mid` ((m, n2), lanes = n2 * inner) the result times mid[k1, j],
    stored as (n2, m * inner)."""
    y = NTT.stockham(x, forward)
    if mid is None:
        return y
    m, lanes = x.shape
    n2 = mid.shape[1]
    y = F.mul(y.reshape(m, n2, lanes // n2), mid[:, :, None])
    return y.transpose(0, 1).reshape(n2, m * (lanes // n2))


def _check(x: torch.Tensor, name: str):
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 Montgomery words, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, "
                         f"got {tuple(x.shape)}")


def sub_ntt(x, forward: bool, mid=None):
    """Size-m NTT along axis 0 of a contiguous (m, lanes) int32 tile (m a
    power of two <= MAX_M). With `mid` (a contiguous (m, n2) Montgomery
    table, n2 dividing lanes) the result is multiplied by mid[k1, j] and
    returned transposed as (n2, m * lanes / n2)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return sub_ntt_plain(x, forward, mid)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    _check(x, "x")
    m, lanes = x.shape
    log_m = m.bit_length() - 1
    if m != 1 << log_m or m > MAX_M:
        raise ValueError(f"sub-transform size {m} is not a power of two "
                         f"<= {MAX_M}")
    if lanes >= 1 << 31:
        raise ValueError(f"{lanes} lanes exceed the kernel's 32-bit index")
    inner = n2 = 1
    if mid is not None:
        _check(mid, "mid")
        n2 = mid.shape[1]
        if mid.shape[0] != m or lanes % n2 or mid.device != x.device:
            raise ValueError(f"mid {tuple(mid.shape)} does not fit x "
                             f"{tuple(x.shape)}")
        inner = lanes // n2
        out = torch.empty((n2, m * inner), dtype=torch.int32, device=x.device)
    else:
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    tw = _device_twiddles(m, forward, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bt_ntt_sub(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                            log_m, lanes,
                            mid.data_ptr() if mid is not None else None,
                            inner, n2, stream)
    if rc != 0:
        raise RuntimeError(f"NTT sub-transform launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
