"""NTT sub-transform: CUDA kernel wrapper (`csrc/ntt.cu`).

`sub_ntt` runs the size-m NTT along axis 0 of an (m, lanes) Montgomery
int32 tile, with the options the four-step and the LDE glue fold into its
loads and stores (see `core/ntt`): a mid-twiddle table and a transposed
store, a zero tail of the input rows, geometric multipliers on the loaded
and on the stored elements, and a cut of the stored rows. On a CUDA tensor
each call launches the hand-written kernel or raises; on a CPU tensor it
runs `sub_ntt_plain`, the same function in plain torch (zero padding, the
multipliers, the port's Stockham stages, the twiddle multiply and the
transpose). There is no fallback from the card to the plain version.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..core import field as F
from ..core import ntt as NTT
from . import build

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # cluster workers launch from threads
MAX_LOG_M = 10  # csrc/ntt.cu MAX_LOG_M
MAX_M = 1 << MAX_LOG_M
LOG_R = 5  # csrc/ntt.cu LOG_R: elements a thread in registers


def _lib():
    return typed(build.load("bt_ntt", "ntt.cu"))


def typed(lib):
    """`lib` (a build of csrc/ntt.cu) with its C entries typed."""
    if not getattr(lib, "_bt_typed", False):
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.bt_ntt_sub.argtypes = [vp, vp, vp, i, u, u, u, vp, u, u, vp, vp,
                                   vp, vp, vp]
        lib.bt_ntt_sub.restype = i
        lib.bt_ntt_max_log_m.argtypes, lib.bt_ntt_max_log_m.restype = [], i
        lib.bt_ntt_blocks_per_sm.argtypes = [i]
        lib.bt_ntt_blocks_per_sm.restype = i
        if lib.bt_ntt_max_log_m() != MAX_LOG_M:
            raise RuntimeError("csrc/ntt.cu and kernels/ntt.py disagree on "
                               "the largest sub-transform")
        lib._bt_typed = True
    return lib


def blocks_per_sm(log_m: int) -> int:
    """Blocks of the size-2^log_m kernel that fit on one SM of the card."""
    n = _lib().bt_ntt_blocks_per_sm(log_m)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def radix_passes(log_m: int) -> list:
    """The kernel's schedule: [(log2 radix, log2 Ns), ...] per pass (the
    mixed-radix Stockham of csrc/ntt.cu: full radix R, the last pass what
    is left)."""
    lr = min(LOG_R, log_m)
    return [(min(lr, log_m - lns), lns) for lns in range(0, log_m, lr or 1)]


@functools.lru_cache(maxsize=None)
def pow_table(m: int, forward: bool) -> np.ndarray:
    """The kernel's one twiddle table: w_m^e for e < m (Montgomery int32),
    w_m the size-m root of the direction. Stage t's radix-2 twiddle
    w_(2s)^j is pow_table[j * m / (2s)]."""
    roots = F.ROU_FWD if forward else F.ROU_REV
    return F.mont_np(NTT._powers(roots[m.bit_length() - 1], m)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_table(m: int, forward: bool, device) -> torch.Tensor:
    return torch.from_numpy(pow_table(m, forward)).to(device)


def _multiplier(tables, rows: int, lanes: int, inner: int):
    """(rows, lanes) words A[row] * B[c // inner] of a (A, B) pair (B may
    be None: A alone)."""
    a, b = tables
    a = a[:rows, None]
    if b is None:
        return a.expand(rows, lanes)
    return F.mul(a, b.repeat_interleave(inner)[None, :lanes])


def sub_ntt_plain(x, forward: bool, mid=None, *, m=None, inner=None,
                  load=None, store=None, rows_out=None):
    """Plain torch version of the kernel (arguments as `sub_ntt`)."""
    rows, lanes = x.shape
    m = rows if m is None else m
    if mid is not None:
        inner = lanes // mid.shape[1]
    inner = lanes if inner is None else inner
    if load is not None:
        x = F.mul(x, _multiplier(load, rows, lanes, inner))
    if rows < m:
        x = torch.cat([x, torch.zeros((m - rows, lanes), dtype=x.dtype,
                                      device=x.device)])
    y = NTT.stockham(x, forward)
    if store is not None:
        y = F.mul(y, _multiplier(store, m, lanes, inner))
    if mid is None:
        return y[:rows_out]
    n2 = mid.shape[1]
    y = F.mul(y.reshape(m, n2, inner), mid[:, :, None])
    return y.transpose(0, 1).reshape(n2, m * inner)


def _check(x: torch.Tensor, name: str, shape=None, device=None):
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 Montgomery words, got {x.dtype}")
    if not x.is_contiguous() or (shape is None and x.dim() != 2) or \
            (shape is not None and tuple(x.shape) != shape):
        raise ValueError(f"{name} must be a contiguous "
                         f"{'2-D' if shape is None else shape} tensor, "
                         f"got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, the tile on {device}")


def check_tile(m: int, rows_in: int, lanes: int) -> int:
    """log2 m of a launch on an (m, lanes) tile with rows_in rows read, or
    ValueError where the kernel cannot take it. A column index is 32-bit
    (lanes < 2^31); every word offset is 64-bit, so a tile may hold any
    number of words (the rv32im data LDE's leading level, 1024 x 2392064,
    is 2^31.19)."""
    log_m = m.bit_length() - 1
    if m != 1 << log_m or m > MAX_M or not 0 <= rows_in <= m:
        raise ValueError(f"sub-transform size {m} is not a power of two "
                         f"<= {MAX_M} holding {rows_in} rows")
    if not 0 <= lanes < 1 << 31:
        raise ValueError(f"{lanes} lanes exceed the kernel's 32-bit column "
                         "index")
    return log_m


def sub_ntt(x, forward: bool, mid=None, *, m=None, inner=None, load=None,
            store=None, rows_out=None):
    """Size-m NTT along axis 0 of the (m, lanes) tile whose first rows are
    the contiguous int32 `x` (rows_in = x.shape[0] <= m; the rest zero; m
    defaults to rows_in, a power of two <= MAX_M).

    * `mid` (a contiguous (m, n2) Montgomery table, n2 dividing lanes): the
      result is multiplied by mid[k1, j] and returned transposed as
      (n2, m * lanes / n2); `inner` is then lanes / n2.
    * `load` / `store`: (A, B) int32 tables, A (m,) and B (lanes / inner,)
      or None: element (row, c) is multiplied by A[row] * B[c // inner]
      as it is loaded / before it is stored (`inner` defaults to lanes).
    * `rows_out`: only the first rows_out rows are returned (no `mid`)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return sub_ntt_plain(x, forward, mid, m=m, inner=inner, load=load,
                             store=store, rows_out=rows_out)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    _check(x, "x")
    rows_in, lanes = x.shape
    m = rows_in if m is None else m
    log_m = check_tile(m, rows_in, lanes)
    n2 = 1
    if mid is not None:
        _check(mid, "mid", device=x.device)
        n2 = mid.shape[1]
        if mid.shape[0] != m or lanes % n2 or \
                (inner is not None and inner != lanes // n2):
            raise ValueError(f"mid {tuple(mid.shape)} does not fit x "
                             f"{tuple(x.shape)}")
        if store is not None or rows_out is not None:
            raise ValueError("the transposed store takes no store options")
        inner = lanes // n2
    inner = lanes if inner is None else inner
    if inner <= 0 or lanes % inner:
        raise ValueError(f"column group {inner} does not divide {lanes}")
    rows_out = m if rows_out is None else rows_out
    if not 0 <= rows_out <= m:
        raise ValueError(f"rows_out {rows_out} outside [0, {m}]")
    tables = []
    for opt, name in ((load, "load"), (store, "store")):
        a, b = opt if opt is not None else (None, None)
        if a is not None:
            _check(a[None], f"{name} A", (1, m), x.device)
        if b is not None:
            if a is None:
                raise ValueError(f"{name} B needs {name} A")
            _check(b[None], f"{name} B", (1, lanes // inner), x.device)
        tables += [a, b]
    if mid is not None:
        out = torch.empty((n2, m * inner), dtype=torch.int32, device=x.device)
    else:
        out = torch.empty((rows_out, lanes), dtype=torch.int32,
                          device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    tw = _device_table(m, forward, x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.bt_ntt_sub(x.data_ptr() if rows_in else None, out.data_ptr(),
                            tw.data_ptr(), log_m, lanes, rows_in, rows_out,
                            ptr(mid), inner, n2, *map(ptr, tables), stream)
    if rc != 0:
        raise RuntimeError(f"NTT sub-transform launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out
