"""RecursionAir's column layouts and constants (frozen copy of the
layout half of `boundless_tpu_torch/recursion/vm.py`; the program builder
and evaluator are left out: the reference verifies, it proves nothing)."""

from __future__ import annotations

import numpy as np

from . import field as F
from . import poseidon2 as P2
from .poseidon2_np import M4

P = F.P

# Opcode indices (ROM sel one-hot).
OPS = ("gen", "input", "bit", "pub", "inv", "az",
       "ppre", "pext", "pint", "pabs", "pzero", "pout")
NOPS = len(OPS)
OP = {name: i for i, name in enumerate(OPS)}

KW = 24  # width of the multi-purpose K block (= Poseidon2 width)
NPUB_GROUPS = 6  # pub vector: 6 groups x 4 scalars
PUB_VALS = 4 * NPUB_GROUPS

# GEN-op K-layout
K_IMM = 0      # [0:4] immediate (ext, canonical here; Montgomery in trace)
K_CMUL = 4
K_CA = 5
K_CB = 6
K_CC = 7
K_PMULW = 8    # [8:12] effective pick-component weights


class _Alloc:
    def __init__(self):
        self.n = 0

    def get(self, k: int = 1):
        s = slice(self.n, self.n + k) if k > 1 else self.n
        self.n += k
        return s


class CtrlCols:
    """ROM layout (the circuit's ctrl group)."""

    def __init__(self):
        a = _Alloc()
        self.sel = a.get(NOPS)
        self.is_first = a.get()
        self.not_last = a.get()
        self.rowidx = a.get()
        self.mcount = a.get()  # WOM read multiplicity (program-static)
        self.a1 = a.get()
        self.a2 = a.get()
        self.a3 = a.get()
        self.en1 = a.get()
        self.en2 = a.get()
        self.en3 = a.get()
        self.K = a.get(KW)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


class DataCols:
    """Per-row data group layout."""

    def __init__(self):
        a = _Alloc()
        self.in1 = a.get(4)
        self.in2 = a.get(4)
        self.in3 = a.get(4)
        self.out = a.get(4)
        self.st = a.get(24)
        self.x3 = a.get(24)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


class AccumCols:
    def __init__(self):
        a = _Alloc()
        self.inw = a.get(4)
        self.inr = [a.get(4) for _ in range(3)]
        self.running = a.get(4)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


CC = CtrlCols()
DC = DataCols()
AC = AccumCols()




# Canonical (non-Montgomery) Poseidon2 constants of core/poseidon2.py.
_EXT_RC, _INT_RC, _MU = P2.canonical_constants()

# Full 24x24 external matrix (M_E = circ(2*M4, M4, ..., M4)) and internal
# matrix (M_I = J + diag(mu)), canonical int64.
def _full_matrices():
    me = np.zeros((24, 24), dtype=np.int64)
    for bi in range(6):
        for bj in range(6):
            blk = M4 * (2 if bi == bj else 1)
            me[4 * bi : 4 * bi + 4, 4 * bj : 4 * bj + 4] = blk
    mi = np.ones((24, 24), dtype=np.int64)
    mi[np.arange(24), np.arange(24)] += _MU
    mi %= P
    return me, mi


M_EXT, M_INT = _full_matrices()


