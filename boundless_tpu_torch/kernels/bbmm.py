"""Exact Baby Bear weighted column sum: CUDA kernel wrapper (`csrc/bbmm.cu`).

`weighted_sum_blocks(blocks, weights)` launches the hand-written kernel on
CUDA tensors: column blocks of the (M, K) int32 values, each an (M, k_b)
or a broadcast (1, k_b) matrix read in place row-major with any row
stride, their widths adding up to K, and (K, W) int32 weights, W = 4 or 8
(one or two extension elements: the widths the prover passes; any other
width raises) -> (M, W) int32, the sum of the Montgomery products
(core/bbmm.py). `weighted_sum(values, weights)` is the one-block call.
CPU tensors are refused: `core/bbmm` sends them to its plain version.

A launch has a block a 64-row tile. A call whose row tiles would not
give the card FILL_BLOCKS blocks an SM, or whose K exceeds the kernel's
SLICE_MAX, splits K over blocks into slices (`plan`): then a second
launch adds the slices' partial sums, and the call counts two launches.

`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import build

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # cluster workers launch from threads
WIDTHS = (4, 8)  # csrc/bbmm.cu's instantiations
# csrc/bbmm.cu's constants (checked against the library when it loads):
# rows a block, words of K a stage, words of K a block, blocks a call.
BM, KT, SLICE_MAX, MAX_BLOCKS = 64, 32, 4096, 128
MAX_SLICES = 65535  # blockIdx.y
FILL_BLOCKS = 4  # blocks an SM below which a call splits K


def _lib():
    lib = build.load("bt_bbmm", "bbmm.cu")
    if not getattr(lib, "_bt_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bt_bbmm.argtypes = [vp, vp, vp, i, vp, i, vp, ll, ctypes.c_uint,
                                vp, vp]
        lib.bt_bbmm.restype = i
        lib.bt_bbmm_blocks_per_sm.argtypes = [i]
        lib.bt_bbmm_blocks_per_sm.restype = i
        layout = (ctypes.c_int * 4)()
        lib.bt_bbmm_layout(layout)
        if tuple(layout) != (BM, KT, SLICE_MAX, MAX_BLOCKS):
            raise RuntimeError(f"csrc/bbmm.cu's constants {tuple(layout)} "
                               f"are not the wrapper's")
        lib._bt_typed = True
    return lib


def blocks_per_sm(width: int) -> int:
    """Blocks of the W = `width` kernel that fit on one SM of the card."""
    n = _lib().bt_bbmm_blocks_per_sm(width)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(m: int, k: int, sms: int) -> tuple:
    """(slice_cols, slices) of an (M, K) call on a card of `sms` SMs: K in
    one slice when the row tiles fill the card, else split into slices of
    whole KT tiles until there are about FILL_BLOCKS blocks an SM; never
    more than SLICE_MAX words a slice."""
    tiles = max(1, -(-k // KT))
    row_tiles = -(-m // BM)
    want = max(-(-k // SLICE_MAX),
               min(tiles, -(-FILL_BLOCKS * sms // max(1, row_tiles))))
    cols = KT * -(-tiles // want)
    return cols, max(1, -(-k // cols))


def check_launch(m: int, k: int, sms: int) -> tuple:
    """`plan` of an (M, K) call, or ValueError where the kernel cannot take
    it. K is indexed in 32 bits, rows and word offsets in 64 (a block's
    row stride too), so the values may hold any number of words (the
    rv32im DEEP sum reads 2^22 x 680, 2^31.4); the grid holds < 2^31 row
    tiles and at most MAX_SLICES slices."""
    if not 0 <= k < 1 << 32:
        raise ValueError(f"K = {k} exceeds the kernel's 32-bit column index")
    if not 0 <= -(-m // BM) < 1 << 31:
        raise ValueError(f"{m} rows need {-(-m // BM)} row tiles")
    cols, slices = plan(m, k, sms)
    if slices > MAX_SLICES:
        raise ValueError(f"K = {k} needs {slices} slices: the kernel takes "
                         f"at most {MAX_SLICES}")
    return cols, slices


def launches_of(m: int, k: int, sms: int) -> int:
    """Kernel launches of an (M, K) call: 2 when K is split."""
    return 1 + (plan(m, k, sms)[1] > 1)


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
    return weighted_sum_blocks([values], weights)


def block_table(blocks) -> tuple:
    """(M, [(pointer, row stride, width)]) of the column blocks as the
    kernel reads them: M the most rows of a block, a block of one row
    broadcast (row stride 0), blocks of no columns left out. Raises on a
    block of other rows, on strides `row_stride` refuses and on more than
    MAX_BLOCKS blocks."""
    m = max(b.shape[0] for b in blocks)
    table = []
    for b in blocks:
        if b.shape[0] not in (m, 1):
            raise ValueError(f"a block of {b.shape[0]} rows among {m}")
        if b.shape[1]:
            ld = row_stride(b) if b.shape[0] == m else 0
            table.append((b.data_ptr(), ld, b.shape[1]))
    if len(table) > MAX_BLOCKS:
        raise ValueError(f"{len(table)} column blocks: the kernel takes at "
                         f"most {MAX_BLOCKS}")
    return m, table


def weighted_sum_blocks(blocks, weights: torch.Tensor) -> torch.Tensor:
    """Column blocks [(M or 1, k_b)] x (sum k_b, W) -> (M, W): the kernel
    on the card (see above). A block of one row is broadcast to all M."""
    global LAUNCHES
    blocks = list(blocks)
    if not blocks:
        raise ValueError("no column blocks")
    for t, name in [(b, "values") for b in blocks] + [(weights, "weights")]:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 words, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.device != weights.device:
            raise ValueError(f"{name} are on {t.device}, weights on "
                             f"{weights.device}")
    m, table = block_table(blocks)
    k = sum(w for _, _, w in table)
    if weights.shape[0] != k:
        raise ValueError(f"values of {k} columns and weights "
                         f"{tuple(weights.shape)} do not contract")
    width = weights.shape[1]
    if width not in WIDTHS:
        raise ValueError(f"the kernel takes W in {WIDTHS}, got {width}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    dev = weights.device
    out = torch.empty((m, width), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cols, slices = check_launch(m, k, _sms(index))
    partial = (torch.empty((slices, m, width), dtype=torch.int32, device=dev)
               if slices > 1 else None)
    n = len(table)
    ptrs = (ctypes.c_void_p * max(1, n))(*[p for p, _, _ in table])
    lds = (ctypes.c_longlong * max(1, n))(*[ld for _, ld, _ in table])
    widths = (ctypes.c_uint * max(1, n))(*[w for _, _, w in table])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bt_bbmm(ptrs, lds, widths, n,
                         weights.data_ptr() if k else None, width,
                         out.data_ptr(), m, cols,
                         partial.data_ptr() if partial is not None else None,
                         stream)
    if rc != 0:
        raise RuntimeError(f"weighted-sum launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES += 1 + (slices > 1)
    return out
