"""AIR definition interface, polymorphic over base/extension algebra.

Counterpart of `boundless_tpu/air/dsl.py`. An AIR's `constraints` method
is written against an abstract algebra `alg`, so the same code evaluates
pointwise over an LDE grid in the base field (`BaseAlg`, prover), at the
DEEP point in the quartic extension (`ExtAlg`, verifier), and as symbolic
degree bounds (`DegreeAlg`, the prover's degree split). The array
algebras hold Montgomery int32 tensors on an explicit device.

This module also owns what a constraint returns and reads: the item
wrappers `ExtVal` and `VecVal`, the column views `ColAccessor` (an
(M, C) tensor, pointwise) and `TapAccessor` (DEEP taps), an AIR's row
view `Rows`, the layout allocator `Alloc` and the LogUp running sum
(`logup_running_sum`). The reference keeps the first four in its prover;
here the prover, the constraint kernel and every AIR import them from
this layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bbmm
from ..core import field as F
from ..core import ntt as NTT


def _mont_vec(vec) -> np.ndarray:
    return F.mont_np(np.asarray(vec, dtype=np.int64)).astype(np.int32)


class ExtVal:
    """Marker wrapper for extension-field constraint values."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


class VecVal:
    """A (..., G) base-field tensor carrying G independent constraints
    (G consecutive alpha powers on the trailing axis)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


class BaseAlg:
    """Algebra over base-field tensors (pointwise LDE evaluation).

    Column reads are base tensors (M,); values touched by mix challenges
    are ext tensors (M, 4). Groups of columns are (M, G) tensors."""

    is_ext = False

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def const(self, c: int):
        return F.const(c, self.device)

    add = staticmethod(F.add)
    sub = staticmethod(F.sub)
    mul = staticmethod(F.mul)
    neg = staticmethod(F.neg)

    def one(self):
        return self.const(1)

    def zero(self):
        return torch.zeros((), dtype=F.I32, device=self.device)

    # --- mixed base/ext operations ---
    def lift(self, b):
        return F.ext_from_base(b)

    emul = staticmethod(F.ext_mul)
    eadd = staticmethod(F.ext_add)
    esub = staticmethod(F.ext_sub)
    eneg = staticmethod(F.ext_neg)

    def escale(self, e, b):
        return F.ext_scale(e, b)

    def read_ext(self, accessor, base_idx: int):
        """Read 4 consecutive base columns as one ext value."""
        return torch.stack([accessor[base_idx + c] for c in range(4)], dim=-1)

    def stack(self, items):
        """Stack base values for a group: (M,) x G -> (M, G)."""
        shape = max((x.shape for x in items), key=len)
        return torch.stack([x.expand(shape) for x in items], dim=-1)

    def pubval(self, x):
        return x

    def ext_const(self, vec):
        return F.ext(vec, self.device)

    def ext_powers(self, x, n: int):
        return NTT.ext_powers(x, n)

    def einv(self, e):
        return F.ext_inv(e)

    def bc(self, e, like):
        return e.expand(like.shape)

    # --- grouped (stacked-column) operations: groups are (M, G) ---
    gmul = staticmethod(F.mul)
    gadd = staticmethod(F.add)
    gsub = staticmethod(F.sub)

    def B(self, s):
        """Scalar value -> broadcastable against a group."""
        return s[..., None] if s.dim() else s

    def gconst(self, vec):
        return torch.from_numpy(_mont_vec(vec)).to(self.device)

    def gsum(self, x):
        return F.sum_mod(x, dim=-1)

    def gweighted(self, x, w_vec):
        """Σ_g w_g * x_g with canonical int weights. Small weights (the
        bit/byte/index weights of the AIRs) multiply the Montgomery words
        directly: Σ x_g w_g mod P is the Montgomery word of the sum, and
        with Σ w_g < 2^32 the int64 sum of words < 2^31 cannot overflow."""
        w = np.asarray(w_vec, dtype=np.int64) % F.P
        if int(w.sum()) < (1 << 32):
            wt = torch.from_numpy(w).to(self.device)
            return ((x.to(torch.int64) * wt).sum(-1) % F.P).to(F.I32)
        return self.gsum(F.mul(x, self.gconst(w)))

    def gweighted_ext(self, x, w_ext):
        """Σ_g w_ext[g] ⊗ x_g -> ext (M, 4). w_ext: (G, 4)."""
        return bbmm.bb_weighted_sum(x, w_ext)

    def gslice(self, x, a, b):
        return x[..., a:b]

    def gshift_sll(self, x, s):
        if not s:
            return x
        return torch.cat([torch.zeros_like(x[:, :s]), x[:, : x.shape[-1] - s]],
                         dim=-1)

    def gshift_srl(self, x, s):
        if not s:
            return x
        return torch.cat([x[:, s:], torch.zeros_like(x[:, :s])], dim=-1)

    def gshift_sra(self, x, s):
        if not s:
            return x
        return torch.cat([x[:, s:], x[:, -1:].expand(x.shape[0], s)], dim=-1)

    def gconcat(self, groups):
        return torch.cat(groups, dim=-1)

    def gpub(self, vec):
        return vec


class ExtAlg:
    """Algebra at the DEEP point: every value is an ext (4,) tensor."""

    is_ext = True

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def const(self, c: int):
        return F.ext_from_base(F.const(c, self.device))

    add = staticmethod(F.ext_add)
    sub = staticmethod(F.ext_sub)
    mul = staticmethod(F.ext_mul)
    neg = staticmethod(F.ext_neg)

    def one(self):
        return self.const(1)

    def zero(self):
        return F.ext_zeros((), self.device)

    def lift(self, b):
        return b

    emul = staticmethod(F.ext_mul)
    eadd = staticmethod(F.ext_add)
    esub = staticmethod(F.ext_sub)
    escale = staticmethod(F.ext_mul)
    eneg = staticmethod(F.ext_neg)

    def read_ext(self, accessor, base_idx: int):
        """Taps of 4 base component columns -> the committed ext value."""
        acc = None
        for c in range(4):
            basis = np.zeros(4, dtype=np.int64)
            basis[c] = 1
            term = F.ext_mul(accessor[base_idx + c], F.ext(basis, self.device))
            acc = term if acc is None else F.ext_add(acc, term)
        return acc

    def stack(self, items):
        """Stack constraint values for a group: (4,) x G -> (G, 4)."""
        return torch.stack([x.expand(4) for x in items], dim=0)

    def pubval(self, x):
        return F.ext_from_base(x)

    def ext_const(self, vec):
        return F.ext(vec, self.device)

    def ext_powers(self, x, n: int):
        return NTT.ext_powers(x, n)

    def einv(self, e):
        return F.ext_inv(e)

    def bc(self, e, like):
        return e.expand(like.shape)

    # --- grouped operations: groups are (G, 4) ext stacks ---
    gmul = staticmethod(F.ext_mul)
    gadd = staticmethod(F.ext_add)
    gsub = staticmethod(F.ext_sub)

    def B(self, s):
        return s[None, :]

    def gconst(self, vec):
        return F.ext_from_base(torch.from_numpy(_mont_vec(vec)).to(self.device))

    def gsum(self, x):
        return F.sum_mod(x, dim=0)

    def gweighted(self, x, w_vec):
        w = torch.from_numpy(_mont_vec(w_vec)).to(self.device)
        return self.gsum(F.mul(x, w[:, None]))

    def gweighted_ext(self, x, w_ext):
        return F.sum_mod(F.ext_mul(x, w_ext), dim=0)

    def gslice(self, x, a, b):
        return x[a:b]

    def gshift_sll(self, x, s):
        if not s:
            return x
        return torch.cat([torch.zeros_like(x[:s]), x[: x.shape[0] - s]], dim=0)

    def gshift_srl(self, x, s):
        if not s:
            return x
        return torch.cat([x[s:], torch.zeros_like(x[:s])], dim=0)

    def gshift_sra(self, x, s):
        if not s:
            return x
        return torch.cat([x[s:], x[-1:].expand(s, 4)], dim=0)

    def gconcat(self, groups):
        return torch.cat(groups, dim=0)

    def gpub(self, vec):
        return F.ext_from_base(vec)


class DegreeAlg:
    """Symbolic degree-bound algebra: values are multiplicative degrees.

    Column reads have degree 1; constants, publics and challenges 0; mul
    adds degrees and add/sub take the max. Running `Air.constraints` under
    it yields per-constraint degree bounds (pure Python/numpy), which the
    prover uses to evaluate low-degree families on smaller grids."""

    is_ext = False

    def const(self, c):
        return 0

    @staticmethod
    def add(a, b):
        return np.maximum(a, b)

    sub = eadd = esub = gadd = gsub = add

    @staticmethod
    def mul(a, b):
        return np.add(a, b)

    emul = gmul = escale = mul

    @staticmethod
    def neg(a):
        return a

    eneg = neg

    def one(self):
        return 0

    def zero(self):
        return 0

    def lift(self, b):
        return b

    def read_ext(self, accessor, base_idx: int):
        return max(int(np.max(accessor[base_idx + c])) for c in range(4))

    def stack(self, items):
        return np.array([int(np.max(x)) for x in items], dtype=np.int64)

    def pubval(self, x):
        return 0

    def ext_const(self, vec):
        return 0

    def ext_powers(self, x, n: int):
        return np.full(n, int(np.max(x)), dtype=np.int64) * np.arange(n)

    def einv(self, e):
        raise NotImplementedError("einv is not polynomial")

    def bc(self, e, like):
        return e

    def B(self, s):
        return s

    def gconst(self, vec):
        return np.zeros(len(np.asarray(vec).ravel()), dtype=np.int64)

    def gsize(self, group):
        return len(np.asarray(group).ravel())

    def gsum(self, x):
        return int(np.max(x))

    def gweighted(self, x, w_vec):
        return int(np.max(x))

    def gweighted_ext(self, x, w_ext):
        x = np.atleast_1d(np.asarray(x))
        w = np.atleast_1d(np.asarray(w_ext))[: len(x)]
        return int(np.max(x + w))

    def gslice(self, x, a, b):
        return np.atleast_1d(x)[a:b]

    def gshift_sll(self, x, s):
        x = np.atleast_1d(x)
        return np.concatenate([np.zeros(s, np.int64), x[: len(x) - s]]) \
            if s else x

    def gshift_srl(self, x, s):
        x = np.atleast_1d(x)
        return np.concatenate([x[s:], np.zeros(s, np.int64)]) if s else x

    def gshift_sra(self, x, s):
        x = np.atleast_1d(x)
        if not s:
            return x
        return np.concatenate([x[s:], np.full(s, x[-1])])

    def gconcat(self, groups):
        return np.concatenate([np.atleast_1d(g) for g in groups])

    def gpub(self, vec):
        return np.zeros(np.shape(vec)[0], dtype=np.int64)


class DegreeCols:
    """Column accessor for DegreeAlg: every read has degree 1."""

    def __getitem__(self, i):
        return 1

    def block(self, idx):
        if isinstance(idx, slice):
            return np.ones(idx.stop - idx.start, dtype=np.int64)
        return np.ones(len(idx), dtype=np.int64)


def constraint_degrees(air, pub) -> list:
    """Per-constraint degree bounds, aligned with air.constraints order.

    Returns [int | np array] per item (VecVal items give per-lane arrays);
    `pub` only supplies shapes."""
    alg = DegreeAlg()
    alg.s_pub_const = 0
    acc = DegreeCols()
    cols = Columns(ctrl=acc, data=acc, accum=acc)
    out = []
    for c in air.constraints(alg, cols, cols, [0, 0] * 4, pub):
        if isinstance(c, VecVal):
            out.append(np.atleast_1d(c.v))
        elif isinstance(c, ExtVal):
            out.append(np.max(np.atleast_1d(c.v)))
        else:
            out.append(int(np.max(c)))
    return out


class Columns:
    """Row accessor handed to `Air.constraints`: cols[i] -> algebra value."""

    def __init__(self, ctrl, data, accum):
        self.ctrl = ctrl
        self.data = data
        self.accum = accum


class ColAccessor:
    """cols[i] -> (M,) base column of an (M, C) tensor (pointwise)."""

    def __init__(self, evals):
        self._evals = evals

    def __getitem__(self, i):
        return self._evals[:, i]

    def block(self, idx):
        """Stacked columns: idx is a slice or index list -> (M, G)."""
        if isinstance(idx, slice):
            return self._evals[:, idx]
        return self._evals[:, torch.as_tensor(idx, device=self._evals.device)]


class TapAccessor:
    """cols[i] -> (4,) ext tap value (DEEP evaluation)."""

    def __init__(self, taps, offset_idx):
        self._taps = taps
        self._o = offset_idx

    def __getitem__(self, i):
        return self._taps[i, self._o]

    def block(self, idx):
        if isinstance(idx, slice):
            return self._taps[idx, self._o]
        return self._taps[torch.as_tensor(idx, device=self._taps.device),
                          self._o]


class Rows:
    """An AIR's view of one row over `Columns`: data(i) / ctrl(i) read a
    column, datab(idx) / ctrlb(idx) a block of them."""

    def __init__(self, cols: Columns):
        self._cols = cols

    @classmethod
    def of_trace(cls, ctrl, data) -> "Rows":
        """The rows of raw (N, C) ctrl and data traces (`accum_trace`)."""
        return cls(Columns(ColAccessor(ctrl), ColAccessor(data), None))

    def data(self, i):
        return self._cols.data[i]

    def ctrl(self, i):
        return self._cols.ctrl[i]

    def datab(self, idx):
        return self._cols.data.block(idx)

    def ctrlb(self, idx):
        return self._cols.ctrl.block(idx)


class Alloc:
    """A column layout's allocator: get() the next index, get(count) the
    next `count` as a slice."""

    def __init__(self):
        self.n = 0

    def get(self, count=1):
        start = self.n
        self.n += count
        return start if count == 1 else slice(start, start + count)


def logup_running_sum(total):
    """(N, 4) per-row LogUp terms -> their running sum, row i the sum of
    rows 0..i: an exact int64 prefix sum (N terms < 2^31 stay below 2^63)
    reduced mod P once, in place of the reference's associative scan
    (field addition is exact, so every order gives the same words)."""
    return (total.to(torch.int64).cumsum(0) % F.P).to(F.I32)


class Air:
    """Subclass and define the class attributes + methods below.

    name; ctrl_cols / data_cols / accum_cols (column counts per group);
    globals_count (ext mix challenges sampled between the data and accum
    commitments); max_degree (<= 5 with the rate-1/4 evaluation grid)."""

    name = "air"
    ctrl_cols = 0
    data_cols = 0
    accum_cols = 0
    globals_count = 0
    max_degree = 2
    # True iff the prover may evaluate the quotient through the generated
    # constraint kernel (kernels/cons.py) on the card; such an AIR
    # provides `cons_pub_pack` / `cons_pub_unpack`.
    fused_cons = False

    def zk_rows(self, po2: int) -> int:
        """Blinded (free random) tail rows per trace; 0 = no blinding."""
        return 0

    def ctrl_trace(self, n: int, device="cpu"):
        return torch.zeros((n, self.ctrl_cols), dtype=F.I32, device=device)

    def accum_trace(self, ctrl, data, globals_):
        assert self.accum_cols == 0
        return torch.zeros((data.shape[0], 0), dtype=F.I32,
                           device=data.device)

    def constraints(self, alg, now: Columns, nxt: Columns, globals_, pub):
        """Return a list of algebra values that must vanish on every row."""
        raise NotImplementedError
