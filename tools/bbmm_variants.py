"""The exact weighted sum's kernel against its first design, on one CUDA card.

    python3 tools/bbmm_variants.py

`tools/bbmm_rows.cu` is the first design of the weighted sum (one thread a
row, W 64-bit sums in registers, the next 32-column tile prefetched into
registers), kept beside this tool only so that the port's kernel
(`boundless_tpu_torch/csrc/bbmm.cu`, the words' bytes through the int8
tensor cores) can be timed against it on the same card; nothing in the
port builds or calls it. `load_rows()` builds it and
`rows_weighted_sum(values, weights)` runs it on a row-major (M, K) CUDA
matrix, outside the port's launch counts.

Run alone, this is `chip_smoke.py`'s `[bbmm]` phase after building the two
libraries (with each kernel's registers, spills and stack, and the
kernel's blocks an SM): every shape of `chip_smoke.BBMM_SHAPES` and
`BBMM_BLOCK_SHAPES` against the plain version word for word, and at
`BBMM_TIMED` the port's kernel and the first design in turns (port, first,
first, port) with `chip_smoke.device_ms`, beside the bound. Prints the
card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tools", "bbmm_rows.cu")


def load_rows():
    """Build (once) and load the first design's library."""
    sys.path.insert(0, ROOT)
    from boundless_tpu_torch.kernels import build

    def text():
        with open(SOURCE) as f:
            return f.read()

    lib = build.load_source("bt_bbmm_rows", text)
    if not getattr(lib, "_bt_typed", False):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bt_bbmm.argtypes = [vp, ll, vp, i, vp, ll, ctypes.c_uint, vp]
        lib.bt_bbmm.restype = i
        lib._bt_typed = True
    return lib


def rows_weighted_sum(values: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The first design on a row-major (M, K) CUDA int32 matrix with unit
    column stride and contiguous (K, W) weights -> (M, W)."""
    m, k = values.shape
    if values.stride(1) != 1 or not weights.is_contiguous():
        raise ValueError("the first design reads row-major values and "
                         "contiguous weights")
    out = torch.empty((m, weights.shape[1]), dtype=torch.int32,
                      device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    rc = load_rows().bt_bbmm(values.data_ptr(), values.stride(0),
                             weights.data_ptr(), weights.shape[1],
                             out.data_ptr(), m, k, stream)
    if rc != 0:
        raise RuntimeError(f"first-design launch failed: CUDA error {rc}")
    return out


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from boundless_tpu_torch.kernels import bbmm as BK
    from boundless_tpu_torch.kernels import build

    sm_clocks_per_s = C.phase_device()
    dev = torch.device("cuda", 0)
    BK._lib()
    load_rows()
    for name in ("bt_bbmm", "bt_bbmm_rows"):
        C.say("build", library=name, registers_spill_stack_bytes=(
            C.ptxas_summary(build.PTXAS_LOG.get(name, ""))))
    C.say("build", library="bt_bbmm", blocks_per_sm=(
        f"w4:{BK.blocks_per_sm(4)},w8:{BK.blocks_per_sm(8)}"))
    C.phase_kernel_bbmm(dev, sm_clocks_per_s)


if __name__ == "__main__":
    main()
