"""Empirical constraint-degree auditor.

The port's counterpart of `boundless_tpu/air/degree.py`. The prover's
composition split assumes every constraint has multiplicative degree
<= CHECK_SPLIT + 1 (deg C(x) <= 5(N-1) with the rate-1/4 LDE). A
constraint that silently exceeds the budget aliases on the LDE: pointwise
trace-domain witness checks still pass and the prover still produces a
proof, but verification fails on the traces that exercise the over-degree
term. So the auditor measures the actual polynomial degree:

  1. fill ctrl/data/accum with uniformly random field words (the generic
     formula degree is realized with overwhelming probability),
  2. evaluate the constraint set pointwise on the oversampled coset LDE
     g*H_{E*N} (E = `expand`, default 16, so degrees up to 16N-1 are
     measurable without aliasing),
  3. INTT back to coefficients (exact field arithmetic) and read off the
     top nonzero coefficient per constraint lane.

The evaluation is eager on the device of the traces (`device`, the card
unless the caller asks for the CPU): on a CUDA tensor the interpolation,
the coset LDE and the INTT run the NTT kernel (`core/ntt.py`), and the
constraints run the AIR's own `constraints` over `BaseAlg`, as the
prover's degree-split route does. The random words are the reference's:
the same numpy draws in the same order (ctrl, data, accum, globals), so
every lane's degree equals the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import field as F
from ..core import ntt as NTT
from .dsl import Air, BaseAlg, ColAccessor, Columns, ExtVal, VecVal


@dataclasses.dataclass(frozen=True)
class ConstraintDegree:
    """Measured degree of one constraint lane."""

    index: int  # position in the list returned by air.constraints()
    lane: int  # lane within a VecVal group / ext component (0 for scalars)
    kind: str  # "base" | "ext" | "vec"
    degree: int  # actual deg C(x) on a size-N trace (N = 1 << po2)

    def mult_degree(self, po2: int) -> float:
        """Degree in trace-polynomial units: deg C / (N - 1)."""
        n = 1 << po2
        return self.degree / (n - 1) if self.degree else 0.0


def _rand_field(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """Uniform words in [0, P), used as Montgomery words (the reference's
    uint32 draws, which fit int32)."""
    words = rng.integers(0, F.P, size=shape, dtype=np.uint32)
    return torch.from_numpy(words.astype(np.int32)).to(device)


def _flatten_constraints(cons):
    """Constraint list -> ((M, K) base column block, per-column labels)."""
    cols = []
    labels = []
    for idx, c in enumerate(cons):
        if isinstance(c, (VecVal, ExtVal)):
            v = c.v  # (M, G) lanes, or (M, 4): ext degree = max component
            kind = "vec" if isinstance(c, VecVal) else "ext"
            labels.extend((idx, g, kind) for g in range(v.shape[-1]))
            cols.append(v)
        else:
            v = c if c.dim() else c[None]
            cols.append(v[:, None])
            labels.append((idx, 0, "base"))
    m = max(x.shape[0] for x in cols)
    cols = [x.expand((m,) + tuple(x.shape[1:])) for x in cols]
    return torch.cat(cols, dim=1), labels


def audit_degrees(air: Air, pub, po2: int = 5, expand: int = 16,
                  seed: int = 0, device="cuda") -> list[ConstraintDegree]:
    """Measure the actual polynomial degree of every constraint of `air`.

    `pub` must have the AIR's public-values shape, on `device` (values are
    irrelevant: they enter constraints as degree-0 constants). Returns one
    ConstraintDegree per scalar constraint lane. Degrees up to
    expand*N - 1 are measured exactly; anything at the ceiling means "at
    least this" (raise `expand`)."""
    dev = torch.device(device)
    n = 1 << po2
    rng = np.random.default_rng(seed)
    traces = [_rand_field(rng, (n, air.ctrl_cols), dev)
              if air.ctrl_cols else None,
              _rand_field(rng, (n, air.data_cols), dev),
              _rand_field(rng, (n, air.accum_cols), dev)
              if air.accum_cols else None]
    globals_ = (_rand_field(rng, (air.globals_count, 4), dev)
                if air.globals_count
                else torch.zeros((0, 4), dtype=F.I32, device=dev))
    evals = [None if t is None else
             NTT.coset_evaluate(NTT.interpolate(t), expand=expand)
             for t in traces]
    # "next row" on the expanded grid: the trace step w_N equals
    # w_{E*N}^E, i.e. a roll by `expand` rows
    now = Columns(*(ColAccessor(e) for e in evals))
    nxt = Columns(*(ColAccessor(None if e is None else
                                torch.roll(e, -expand, dims=0))
                    for e in evals))
    cons = air.constraints(BaseAlg(dev), now, nxt, globals_, pub)
    flat, labels = _flatten_constraints(cons)  # (E*N, K)
    # C(g*y) on H_{E*N} -> coefficients of C(g*y); same degree as C. A
    # Montgomery word is 0 iff its value is.
    coeffs = NTT.intt(flat.contiguous()).cpu().numpy()
    nonzero = coeffs != 0
    top = coeffs.shape[0] - 1 - np.argmax(nonzero[::-1], axis=0)
    degree = np.where(nonzero.any(axis=0), top, 0)
    return [ConstraintDegree(index=idx, lane=lane, kind=kind,
                             degree=int(degree[k]))
            for k, (idx, lane, kind) in enumerate(labels)]


def degree_budget(po2: int, check_split: int = 4) -> int:
    """Max deg C(x) the composition split can represent soundly.

    Q(x) = C(x) / (x^N - 1) is committed as CHECK_SPLIT polynomials of
    degree < N via Q(x) = sum_i x^i Q_i(x^4), so deg Q <= CHECK_SPLIT*N - 1
    and deg C <= (CHECK_SPLIT + 1)*N - 1.
    """
    n = 1 << po2
    return (check_split + 1) * n - 1


def assert_degrees(air: Air, pub, po2: int = 5, expand: int = 16,
                   seed: int = 0, device="cuda") -> list[ConstraintDegree]:
    """Audit + raise if any constraint exceeds the declared or hard budget.

    Hard failure: deg C > degree_budget (the split cannot represent Q —
    the proof system is unsound for this AIR).
    Also fails if any constraint exceeds air.max_degree * (N - 1): the
    declared degree is a lie even if the split still happens to fit.
    """
    degs = audit_degrees(air, pub, po2=po2, expand=expand, seed=seed,
                         device=device)
    n = 1 << po2
    declared = air.max_degree * (n - 1)
    hard = degree_budget(po2)
    # Blinded AIRs (zk tail rows): point-class composition terms gain
    # deg Z from the P_Z factor (prover/stark._cons_plan), so their
    # measured deg C must satisfy deg C - N + Z <= hard - N, i.e. the
    # point-class budget is `hard - zk`. The class list aligns with the
    # audit's constraint indices (air._zclass from the audit's own
    # constraints() run).
    zk = air.zk_rows(po2) if hasattr(air, "zk_rows") else 0
    zclass = getattr(air, "_zclass", None) if zk else None

    def _hard(d):
        if zclass is not None and not zclass[d.index]:
            return hard - zk
        return hard

    bad = [d for d in degs if d.degree > declared or d.degree > _hard(d)]
    if bad:
        lines = [
            f"constraint[{d.index}] lane {d.lane} ({d.kind}): deg {d.degree}"
            f" = {d.degree / (n - 1):.2f}x(N-1)"
            f" > declared {declared} (max_degree={air.max_degree})"
            + (f", EXCEEDS split budget {hard}" if d.degree > hard else "")
            for d in bad
        ]
        raise AssertionError(
            f"{air.name}: {len(bad)} constraint(s) over degree budget"
            f" (N={n}):\n" + "\n".join(lines))
    return degs
