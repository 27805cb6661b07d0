"""The trace upload: CUDA kernel wrapper (`csrc/upload.cu`).

`upload(words, device)` hands a trace of canonical integers on the host to
a CUDA device as Montgomery int32 words, word-equal to `core/field.fp`:
the host copies the int64 words as they lie, in blocks of rows (one 2-D
copy a block, at the array's row pitch) through two staging buffers on
the card, and the kernel converts each block there. The array is read in
place when it is int64 with unit column stride (a column slice such as
the witness's `data[:, :392]` among them); anything else is first made
one by `np.asarray(..., int64)` and `np.ascontiguousarray`.

The staging is allocated per call (two buffers of at most STAGE_BYTES
each, from the caching allocator on the caller's stream), so the
cluster's prove threads upload at once without sharing it. A block holds
the most rows whose words fit a buffer (`block_rows`).

`LAUNCHES` counts kernel launches: one a block.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import build

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # cluster workers upload from threads
STAGE_BYTES = 64 << 20  # one staging buffer; a call holds two


def _lib():
    lib = build.load("bt_upload", "upload.cu")
    if not getattr(lib, "_bt_typed", False):
        typed(lib)
        lib._bt_typed = True
    return lib


def typed(lib):
    """Declare `bt_upload`'s C signature on a loaded library."""
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.bt_upload.argtypes = [vp, ll, ctypes.c_int, ll, ll, vp, ll, vp, vp,
                              ctypes.POINTER(ll)]
    lib.bt_upload.restype = ctypes.c_int


def host_rows(words) -> np.ndarray:
    """`words` as a 2-D int64 array the kernel reads in place: unit column
    stride and a row pitch of at least its columns, 8-byte aligned. The
    trailing axis is the columns (a scalar is one word). A view that
    qualifies is returned as it lies; anything else is converted or
    copied."""
    a = np.asarray(words, dtype=np.int64)
    a = a.reshape(math.prod(a.shape[:-1]), a.shape[-1]) if a.ndim else \
        a.reshape(1, 1)
    rows, cols = a.shape
    s0, s1 = a.strides
    if a.flags.aligned and (s1 == 8 or cols <= 1) and \
            (rows <= 1 or (s0 % 8 == 0 and s0 >= 8 * cols)):
        return a
    return np.ascontiguousarray(a)


def pitch(a: np.ndarray) -> int:
    """The row pitch, in words, of a `host_rows` array."""
    return a.strides[0] // 8 if a.shape[0] > 1 else a.shape[1]


def block_rows(cols: int) -> int:
    """Rows a staging block takes: the most whose cols words each fit
    STAGE_BYTES; one at least."""
    return max(1, STAGE_BYTES // (8 * cols))


def convert(lib, a: np.ndarray, out: torch.Tensor, stage: torch.Tensor,
            rows_a_block: int, stream) -> int:
    """Run `bt_upload` of `lib`: the `host_rows` array `a` through the two
    halves of `stage` (int64, each at least `rows_a_block` rows) into `out`
    ((rows, cols) int32, contiguous), `rows_a_block` rows a block, on
    `stream` (a CUDA stream handle, or None on an emulated library).
    Counts and returns the launches."""
    global LAUNCHES
    rows, cols = a.shape
    half = stage.numel() // 2
    launches = ctypes.c_longlong(0)
    rc = lib.bt_upload(a.ctypes.data, rows, cols, pitch(a), rows_a_block,
                       stage.data_ptr(), half, out.data_ptr(), stream,
                       ctypes.byref(launches))
    if rc != 0:
        raise RuntimeError(f"trace upload failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += launches.value
    return launches.value


def upload(words, device) -> torch.Tensor:
    """Canonical integers on the host -> Montgomery int32 words on the
    CUDA `device`, of `words`' shape (see above)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the upload kernel runs on a CUDA device, got "
                         f"{device}")
    shape = np.shape(words)
    a = host_rows(words)
    rows, cols = a.shape
    out = torch.empty((rows, cols), dtype=torch.int32, device=device)
    if out.numel():
        n = min(block_rows(cols), rows)
        stage = torch.empty(2 * n * cols, dtype=torch.int64, device=device)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            convert(_lib(), a, out, stage, n, stream)
    return out.reshape(shape)
