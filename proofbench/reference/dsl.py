"""AIR definition interface, polymorphic over base/extension algebra.

Frozen copy of `boundless_tpu_torch/air/dsl.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/air/dsl.py`. An AIR's `constraints` method
is written against an abstract algebra `alg`, so the same code evaluates
pointwise over an LDE grid in the base field (`BaseAlg`, prover), at the
DEEP point in the quartic extension (`ExtAlg`, verifier); the copy leaves
out the symbolic degree algebra, which only the prover's degree split
uses. The algebras hold Montgomery int32 tensors on an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import ntt as NTT


def _mont_vec(vec) -> np.ndarray:
    return F.mont_np(np.asarray(vec, dtype=np.int64)).astype(np.int32)


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
        return F.weighted_sum(x, w_ext)

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


class Columns:
    """Row accessor handed to `Air.constraints`: cols[i] -> algebra value."""

    def __init__(self, ctrl, data, accum):
        self.ctrl = ctrl
        self.data = data
        self.accum = accum


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
