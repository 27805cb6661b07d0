"""Debug utilities: check a witness satisfies an AIR on the trace domain.

The port's counterpart of `boundless_tpu/air/debug.py`. Evaluating the
constraints directly on H_N (rows with a cyclic next row) is orders of
magnitude cheaper than a full proof: the development loop for new AIR
features, and the first thing to run when a proof fails its ALI check.
The evaluation is eager on the device of `data` (no jit cache).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import field as F
from . import dsl
from .dsl import ColAccessor, ExtVal, VecVal


def check_constraints(air, ctrl, data, pub, globals_seed: int = 7):
    """Returns (ok, failures): failures = list of (constraint_index, count).

    ctrl/data: Montgomery (N, C) int32 tensors on one device (ctrl may be
    None for an AIR without control columns). Globals are pseudorandomly
    drawn (any values must satisfy a correct witness identically)."""
    dev = data.device
    rng = np.random.default_rng(globals_seed)
    globals_ = F.ext(rng.integers(1, F.P, size=(max(air.globals_count, 1), 4),
                                  dtype=np.int64), dev)[: air.globals_count]
    n = data.shape[0]
    accum = (air.accum_trace(ctrl, data, globals_) if air.accum_cols
             else torch.zeros((n, 0), dtype=F.I32, device=dev))
    po2 = int(n).bit_length() - 1
    zk = air.zk_rows(po2) if hasattr(air, "zk_rows") else 0

    def roll(t):
        return None if t is None else torch.roll(t, -1, dims=0)

    now = dsl.Columns(ColAccessor(ctrl), ColAccessor(data), ColAccessor(accum))
    nxt = dsl.Columns(ColAccessor(roll(ctrl)), ColAccessor(roll(data)),
                      ColAccessor(roll(accum)))
    cons = air.constraints(dsl.BaseAlg(dev), now, nxt, globals_, pub)
    zclass = getattr(air, "_zclass", None) if zk else None
    failures = []
    for i, c in enumerate(cons):
        if isinstance(c, (ExtVal, VecVal)):
            c = c.v
        vals = F.from_mont(c)
        if zclass is not None and not zclass[i]:
            # point-class family: binds REAL rows only (the blinded zk
            # tail is free — prover/stark._cons_plan)
            vals = vals[: n - zk]
        count = int(torch.count_nonzero(vals))
        if count:
            failures.append((i, count))
    return (not failures), failures
