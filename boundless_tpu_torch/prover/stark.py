"""DEEP-ALI STARK prover/verifier over Baby Bear, on torch tensors.

Counterpart of `boundless_tpu/prover/stark.py`, with the same protocol and
transcript schedule, so a proof of either package is word for word the
proof of the other:

  trace groups ctrl/data/accum on H_N -> LDE on the coset g*H_{4N} (the
  constraint grid), Merkle commits over the commit subdomain g*H_{cN} ->
  constraint mix alpha -> composition Q = Σ_k alpha^k C_k / Z (degree
  split over the N/2N/4N grids, zk divisor classes) -> 16 base columns of
  the split Q committed -> DEEP point z, taps at z, z*g_N, z^4 -> DEEP
  batch mix beta -> combined quotient on the commit domain -> FRI, with
  Merkle openings of every group at the FRI query points.

PyTorch runs eagerly: there is no jit, no buffer donation and no XLA
scheduling knob. Every tensor of a proof lives on the device of the input
trace. The quotient has two routes with bit-identical coefficients (the
reference's `stark.py:484-534`): for an AIR that declares the kernel
(`fused_cons`, rv32im) on a CUDA card the fused route, one pass of the
generated constraint kernel over the 4N grid (`kernels/cons.py`) and one
masked α-combine per divisor class; otherwise (the CPU, and the recursion
AIR on any device) the degree-split route, one eager `constraints` pass
per N/2N/4N grid.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import bbmm
from ..core import field as F
from ..core import fri, merkle, sharded
from ..core import ntt as NTT
from ..core.ntt import _powers as _np_powers
from ..air import cons_eval
from ..air.dsl import (Air, BaseAlg, ColAccessor, Columns, ExtAlg, ExtVal,
                       TapAccessor, VecVal, constraint_degrees)
from ..kernels import cons as CK
from ..utils import profiling

INV_RATE = 4
EXT = 4
CHECK_SPLIT = 4  # composition split factor
CHECK_COLS = CHECK_SPLIT * EXT  # 16 base columns


@dataclasses.dataclass(frozen=True)
class ProofSystem:
    """STARK parameterization (the reference's ProofSystem).

    `commit_expand` is the commitment blowup (code rate 1/commit_expand);
    constraints are always evaluated on the 4N grid."""

    queries: int = 100
    fri_min_degree: int = 256
    commit_expand: int = 2
    hash: str = "poseidon2"

    def suite(self):
        from ..core import suites

        return suites.get(self.hash)


class GroupOpening(NamedTuple):
    rows: torch.Tensor  # (Q, C)
    paths: torch.Tensor  # (Q, depth, 8)


class SegmentProof(NamedTuple):
    """The reference's SegmentProof fields, as tensors."""

    ctrl_root: Optional[torch.Tensor]
    data_root: torch.Tensor
    accum_root: Optional[torch.Tensor]
    check_root: torch.Tensor
    taps_ctrl: Optional[torch.Tensor]  # (ctrl_cols, 2, 4): taps at z, z*gN
    taps_data: torch.Tensor  # (data_cols, 2, 4)
    taps_accum: Optional[torch.Tensor]  # (accum_cols, 2, 4)
    taps_check: torch.Tensor  # (16, 4): taps at z^4
    open_ctrl: Optional[GroupOpening]
    open_data: GroupOpening
    open_accum: Optional[GroupOpening]
    open_check: GroupOpening
    fri_proof: fri.FriProof


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _tensor(a: np.ndarray, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _blocks(trace) -> tuple:
    """A trace group's column blocks: a ShardedTrace's, or the one tensor."""
    return (trace.blocks if isinstance(trace, sharded.ShardedTrace)
            else (trace,))


def _whole(trace):
    """A trace group's whole (N, C) matrix on its leader."""
    return (trace.gather() if isinstance(trace, sharded.ShardedTrace)
            else trace)


def _lde_commit(trace, commit_expand: int, suite):
    """trace (N, C) on H_N, or a ShardedTrace -> (coeffs, eval4 (4N, C),
    commit tree).

    coeffs: each block's (N, c_k) coefficients, a tuple in column order on
    the blocks' devices. Each block is interpolated and extended on its
    own device; a sharded group's 4N evaluations are gathered on the
    leader, each shard's freed once copied. The tree commits the
    stride-(4/c) subset of the 4N grid, which is the commit domain
    g*H_{cN}, each block's columns on its own device."""
    blocks = _blocks(trace)
    leader = blocks[0].device
    step = INV_RATE // commit_expand
    coeffs, committed, evals, off = [], [], None, 0
    for k, block in enumerate(blocks):
        coeffs.append(NTT.interpolate(block))
        ev = NTT.coset_evaluate(coeffs[-1], expand=INV_RATE)
        committed.append(ev if step == 1 else ev[::step].contiguous())
        if len(blocks) == 1:
            evals = ev
            continue
        if evals is None:
            evals = torch.empty((ev.shape[0], sum(b.shape[1] for b in blocks)),
                                dtype=F.I32, device=leader)
        width = ev.shape[1]
        evals[:, off:off + width] = (ev if k == 0
                                     else sharded.move(ev, leader))
        off += width
        del ev
    tree = suite.commit(committed[0] if len(committed) == 1
                        else tuple(committed))
    return tuple(coeffs), evals, tree


def combine_constraints(cons, alpha, at_deep: bool, keep=None, powers=None):
    """Σ_k alpha^k ⊙ C_k -> (..., 4).

    `keep` (optional bool list aligned with cons) selects the items that
    enter the sum; alpha-power offsets are assigned over the full list,
    so per-class partial sums add up to the single-pass combination.
    `powers`: a dict in which the caller keeps alpha's powers by count
    across calls with the same alpha (the quotient's grids and jobs)."""
    sizes = []
    for c in cons:
        if isinstance(c, VecVal):
            sizes.append(c.v.shape[-2] if at_deep else c.v.shape[-1])
        else:
            sizes.append(1)
    powers = {} if powers is None else powers
    if sum(sizes) not in powers:
        powers[sum(sizes)] = NTT.ext_powers(alpha, sum(sizes))
    apows = powers[sum(sizes)]

    if not at_deep:
        return _combine_pointwise(cons, sizes, apows, keep)

    acc = None
    k = 0
    for i, (c, g) in enumerate(zip(cons, sizes)):
        if keep is not None and not keep[i]:
            k += g
            continue
        if isinstance(c, VecVal):
            term = F.sum_mod(F.ext_mul(apows[k: k + g], c.v), 0)
        else:
            if isinstance(c, ExtVal):
                c = c.v
            term = F.ext_mul(apows[k].expand(c.shape), c)
        acc = term if acc is None else F.ext_add(acc, term)
        k += g
    return acc


def _combine_pointwise(cons, sizes, apows, keep=None):
    """Pointwise alpha-combine: one exact weighted sum (core/bbmm.py) over
    the items as they lie, no concatenation on the card. A base column or
    a VecVal enters with its alpha powers; an ExtVal item c with power a
    enters as its four coordinates under the rows a * X^i (i = 0..3):
    a * c = sum_i c_i (a X^i), coordinate-wise base products, so the sum
    equals the reference's ext_mul / ext_add terms word for word."""
    blocks, weights, ext_blocks, ext_powers = [], [], [], []
    k = 0
    for i, (c, g) in enumerate(zip(cons, sizes)):
        if keep is not None and not keep[i]:
            k += g
            continue
        if isinstance(c, VecVal):
            blocks.append(c.v)
            weights.append(apows[k: k + g])
        elif isinstance(c, ExtVal):
            ext_blocks.append(c.v if c.v.dim() == 2 else c.v[None])
            ext_powers.append(apows[k])
        else:
            blocks.append(c[:, None])
            weights.append(apows[k: k + 1])
        k += g
    if ext_blocks:
        blocks += ext_blocks
        weights.append(_times_basis(torch.stack(ext_powers)))
    if not blocks:
        return None
    return bbmm.bb_weighted_sum_blocks(blocks, torch.cat(weights, 0))


def _times_basis(a):
    """(E, 4) ext elements -> (4 E, 4): the rows a_e * X^i, i = 0..3, of
    each in turn (Montgomery words)."""
    e = a.shape[0]
    basis = F.ONE * torch.eye(EXT, dtype=F.I32, device=a.device)
    return F.ext_mul(a[:, None, :].expand(e, EXT, EXT),
                     basis[None].expand(e, EXT, EXT)).reshape(e * EXT, EXT)


# Below this row count one 4N-grid constraint pass serves every item (the
# reference's CI-size setting); at or above it low-degree families run on
# the N / 2N subgrids.
SPLIT_MIN_ROWS = 4096


_DEGREES_LOCK = threading.Lock()  # proofs run in the cluster's threads


def _item_degrees(air, pub):
    """Per-constraint-item degree bounds and the zk class list (cached)."""
    with _DEGREES_LOCK:
        if "_item_degrees" not in air.__dict__:
            air.__dict__["_item_degrees"] = [
                int(np.max(np.atleast_1d(d)))
                for d in constraint_degrees(air, pub)]
            air.__dict__["_zclass_cache"] = \
                list(getattr(air, "_zclass", [])) or None
        return air.__dict__["_item_degrees"], air.__dict__["_zclass_cache"]


def _cons_plan(air, pub, po2: int):
    """(zk, [(expand, [(keep_mask, is_point), ...]), ...]): each grid
    evaluates the constraint list once; each job combines a subset and
    divides by Z_H (trans class) or Z_H / P_Z (point class)."""
    n = 1 << po2
    zk = air.zk_rows(po2)
    degs, zclass = _item_degrees(air, pub)
    if zk and zclass is None:
        raise ValueError("blinded AIR did not report constraint classes")
    if not zk:
        zclass = [True] * len(degs)
    split = n >= SPLIT_MIN_ROWS

    def expand_of(d: int, is_point: bool) -> int:
        if not split:
            return INV_RATE
        qdeg = d * (n - 1) - n + (zk if is_point else 0)
        for e in (1, 2):
            if qdeg < e * n:
                return e
        return INV_RATE

    groups = {}
    for i, (d, trans) in enumerate(zip(degs, zclass)):
        key = (expand_of(d, not trans), not trans)
        groups.setdefault(key, [False] * len(degs))[i] = True
    plan = {}
    for (e, is_point), mask in sorted(groups.items(), reverse=True):
        plan.setdefault(e, []).append(
            (None if len(groups) == 1 else mask, is_point))
    return zk, sorted(plan.items(), reverse=True)


def _coset_np(n: int, expand: int) -> np.ndarray:
    """Canonical points g*H_{expand*N} (int64)."""
    big = expand * n
    return _np_powers(F.ROU_FWD[big.bit_length() - 1], big) * F.GENERATOR % F.P


@functools.lru_cache(maxsize=None)
def _commit_xs(n: int, expand: int) -> np.ndarray:
    """Commit-domain points g*H_{expand*N} (Montgomery int32)."""
    return F.mont_np(_coset_np(n, expand)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _inv_z_np(n: int, expand: int) -> np.ndarray:
    """1/Z(x) = 1/(x^N - 1) on g*H_{expand*N}, canonical int64.

    x^N = g^N w^{iN} cycles with period `expand`."""
    big = expand * n
    w = F.ROU_FWD[big.bit_length() - 1]
    gn, wn = pow(F.GENERATOR, n, F.P), pow(w, n, F.P)
    zinv = [pow((gn * pow(wn, i, F.P) - 1) % F.P, F.P - 2, F.P)
            for i in range(expand)]
    return np.tile(np.array(zinv, dtype=np.int64), n)


def _zk_root_ints(n: int, zk: int) -> list:
    """The blinded-tail trace points w_N^j, j = n-zk..n-1 (canonical)."""
    wn = F.ROU_FWD[n.bit_length() - 1]
    return [pow(wn, j, F.P) for j in range(n - zk, n)]


@functools.lru_cache(maxsize=None)
def _divisor_np(n: int, expand: int, zk: int, is_point: bool) -> np.ndarray:
    """The job divisor on g*H_{expand*N} (Montgomery int32): 1/Z_H for the
    trans class, P_Z/Z_H for the point class."""
    vals = _inv_z_np(n, expand)
    if is_point:
        xs = _coset_np(n, expand)
        pz = np.ones_like(xs)
        for r in _zk_root_ints(n, zk):
            pz = pz * ((xs - r) % F.P) % F.P
        vals = pz * vals % F.P
    return F.mont_np(vals).astype(np.int32)


def _recombine_check_taps(taps_check):
    """(16, 4) base-component taps -> Q_i(z^4) ext values (4, 4)."""
    dev = taps_check.device
    qs = []
    for i in range(CHECK_SPLIT):
        acc = None
        for c in range(EXT):
            basis = np.zeros(4, dtype=np.int64)
            basis[c] = 1
            term = F.ext_mul(taps_check[i * EXT + c], F.ext(basis, dev))
            acc = term if acc is None else F.ext_add(acc, term)
        qs.append(acc)
    return torch.stack(qs)


def _deep_points(z, n: int):
    """The three DEEP opening points: z, z*g_N, z^4."""
    g_n = F.const(F.ROU_FWD[n.bit_length() - 1], z.device)
    return z, F.ext_scale(z, g_n), F.ext_pow_const(z, 4)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


def _fused_route(air, device) -> bool:
    """The fused constraint-kernel route runs on the card, for an AIR that
    declares the kernel (the reference's `pallas_cons_ok` gate); every
    other AIR takes the degree-split route on any device."""
    return (device.type == "cuda" and air.fused_cons
            and air.ctrl_cols > 0 and air.accum_cols > 0)


def _quotient_coeffs(air, po2: int, evals, globals_, pub, alpha,
                     fused: bool):
    """Q = Σ_k alpha^k C_k / Z as (4N, 4) coefficients, from the 4N-grid
    evaluations `evals` = (ctrl, data, accum).

    `fused=False` (the degree-split route): one constraints() pass per
    g*H_{expand*N} subgrid of the plan, per job an alpha-combine of its
    items times its class divisor, interpolated on that subgrid; the parts
    are summed. `fused=True` (the reference's fused-kernel route,
    `stark.py:484-498`): one pass of the constraint kernel over the 4N
    grid (`kernels/cons.evaluate_combined`), which returns one masked
    alpha-combine per divisor class (the union of that class's jobs: the
    combine is linear; on the card no (K, M) rows are stored), each times
    its 4N divisor table, summed and interpolated once. Every part has
    degree < its grid, so both give the same coefficients word for word.
    """
    n = 1 << po2
    ctrl_evals, data_evals, accum_evals = evals
    dev = data_evals.device
    zk, plan = _cons_plan(air, pub, po2)

    def interpolate_parts(expand: int, parts):
        """Σ comb / Z_class over the (comb, is_point) parts on the
        g*H_{expand*N} grid -> (expand*N, 4) coefficients."""
        q_ev = None
        for comb, is_point in parts:
            div = _tensor(_divisor_np(n, expand, zk, is_point), dev)
            term = F.mul(comb, div[:, None])
            q_ev = term if q_ev is None else F.ext_add(q_ev, term)
        return NTT.coset_interpolate(q_ev, expand=1)

    if fused:
        kinds = cons_eval.trace(air).kinds
        classes = {}
        for _, jobs in plan:
            for keep, is_point in jobs:
                mask = classes.setdefault(is_point, [False] * len(kinds))
                for i in range(len(kinds)):
                    mask[i] = mask[i] or keep is None or bool(keep[i])
        order = sorted(classes)
        combs = CK.evaluate_combined(air, ctrl_evals, data_evals, accum_evals,
                                     globals_, pub, alpha,
                                     [classes[p] for p in order])
        return interpolate_parts(INV_RATE, zip(combs, order))

    powers = {}  # alpha's powers, computed once for every grid and job

    def eval_grid(expand: int, jobs):
        step = INV_RATE // expand

        def sub(ev):
            return ev if (ev is None or step == 1) else ev[::step]

        def nxt_of(ev):
            return None if ev is None else torch.roll(ev, -expand, dims=0)

        subs = [sub(e) for e in evals]
        now = Columns(*(ColAccessor(e) for e in subs))
        nxt = Columns(*(ColAccessor(nxt_of(e)) for e in subs))
        cons = air.constraints(BaseAlg(dev), now, nxt, globals_, pub)
        return interpolate_parts(expand, (
            (combine_constraints(cons, alpha, at_deep=False, keep=keep,
                                 powers=powers),
             is_point) for keep, is_point in jobs))

    q_coeffs = torch.zeros((INV_RATE * n, EXT), dtype=F.I32, device=dev)
    for expand, jobs in plan:
        c_e = eval_grid(expand, jobs)
        q_coeffs[: c_e.shape[0]] = F.add(q_coeffs[: c_e.shape[0]], c_e)
    return q_coeffs


def prove(air: Air, data_trace, pub, po2: int,
          ps: ProofSystem = ProofSystem(), ctrl_trace=None) -> SegmentProof:
    """Prove one segment on the device of `data_trace`.

    `pub`: public-values dataclass of Montgomery tensors, bound into the
    transcript first. `ctrl_trace`: required iff `air.ctrl_dynamic`.

    `data_trace` and `ctrl_trace` may each be a `sharded.ShardedTrace`, its
    columns spread over a tp group's devices (`core/sharded.py`): each
    shard's LDE, leaf hash (chained in column order), DEEP taps and part
    of the DEEP weighted sums run on the shard's device, and the rest on
    the leader, the data's first device, which holds `pub`. The proof is
    word for word the one of the whole traces on one device."""
    n = 1 << po2
    data_blocks = _blocks(data_trace)
    shape = (data_blocks[0].shape[0], sum(b.shape[1] for b in data_blocks))
    assert shape == (n, air.data_cols)
    dev = data_blocks[0].device
    if isinstance(ctrl_trace, sharded.ShardedTrace) and \
            ctrl_trace.leader != dev:
        raise ValueError(f"ctrl's leader {ctrl_trace.leader} is not the "
                         f"data's {dev}")
    with profiling.span("stark.prove", sync=True, device=dev, po2=po2,
                        variant=air.name, cols=air.data_cols):
        return _prove(air, data_trace, pub, po2, ps, ctrl_trace, dev)


def _stage(name: str, dev, **attrs):
    """A synchronised span of one stage of `prove`."""
    return profiling.span(name, sync=True, device=dev, **attrs)


def _prove(air, data_trace, pub, po2, ps, ctrl_trace, dev) -> SegmentProof:
    n = 1 << po2
    suite = ps.suite()
    tr = suite.transcript(dev)
    tr.mix_pub(pub)

    has_ctrl = air.ctrl_cols > 0
    has_accum = air.accum_cols > 0
    ctrl_evals = accum_evals = None
    # the data LDE's words: the largest tensor of a proof
    with _stage("stark.commit", dev, variant=air.name, cols=air.data_cols,
                lde_words=INV_RATE * n * air.data_cols):
        if has_ctrl and ctrl_trace is None:
            assert not getattr(air, "ctrl_dynamic", False), \
                "this AIR requires a ctrl_trace argument"
            ctrl_trace = air.ctrl_trace(n, dev)
        if has_ctrl:
            ctrl_coeffs, ctrl_evals, ctrl_tree = _lde_commit(
                ctrl_trace, ps.commit_expand, suite)
            tr.mix_digest(ctrl_tree.root)
        data_coeffs, data_evals, data_tree = _lde_commit(
            data_trace, ps.commit_expand, suite)
        tr.mix_digest(data_tree.root)

    # --- phase 2: mix challenges + accumulators ---
    with _stage("stark.accum", dev):
        globals_ = (torch.stack([tr.sample_ext()
                                 for _ in range(air.globals_count)])
                    if air.globals_count else
                    torch.zeros((0, EXT), dtype=F.I32, device=dev))
        if has_accum:
            accum_trace = air.accum_trace(
                None if ctrl_trace is None else _whole(ctrl_trace),
                _whole(data_trace), globals_)
            accum_coeffs, accum_evals, accum_tree = _lde_commit(
                accum_trace, ps.commit_expand, suite)
            tr.mix_digest(accum_tree.root)

    # --- composition polynomial ---
    with _stage("stark.quotient", dev):
        alpha = tr.sample_ext()
        fused = _fused_route(air, dev)
        q_coeffs = _quotient_coeffs(air, po2, (ctrl_evals, data_evals,
                                               accum_evals), globals_, pub,
                                    alpha, fused)

    # Split Q(x) = Σ_i x^i Q_i(x^4); commit the 16 base component columns.
    with _stage("stark.check", dev):
        check_coeffs = torch.cat(
            [q_coeffs[i::CHECK_SPLIT] for i in range(CHECK_SPLIT)], dim=1)
        check_evals = NTT.coset_evaluate(check_coeffs,
                                         expand=ps.commit_expand)
        check_tree = suite.commit(check_evals)
        tr.mix_digest(check_tree.root)

    # --- DEEP taps and combination (on the commit domain) ---
    with _stage("stark.deep", dev):
        z = tr.sample_ext()
        z_, zg, z4 = _deep_points(z, n)

        def taps_of(coeffs):
            """(C, 2, 4) taps at z and z*g_N of each block's columns on its
            own device, joined in column order on the leader."""
            parts = []
            for k, c in enumerate(coeffs):
                at = (z_, zg) if k == 0 else (sharded.move(z_, c.device),
                                              sharded.move(zg, c.device))
                t = torch.stack([NTT.eval_poly_ext(c, x) for x in at], dim=1)
                parts.append(t if k == 0 else sharded.move(t, dev))
            return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

        taps_ctrl = taps_of(ctrl_coeffs) if has_ctrl else None
        taps_data = taps_of(data_coeffs)
        taps_accum = taps_of(accum_coeffs) if has_accum else None
        taps_check = NTT.eval_poly_ext(check_coeffs, z4)

        all_taps = [t for t in (taps_ctrl, taps_data, taps_accum)
                    if t is not None]
        tr.mix_elems(torch.cat([t.reshape(-1) for t in all_taps]
                               + [taps_check.reshape(-1)]))

        beta = tr.sample_ext()
        trees = [t for t, present in (
            (ctrl_tree if has_ctrl else None, has_ctrl), (data_tree, True),
            (accum_tree if has_accum else None, has_accum)) if present]
        trace_taps = torch.cat(all_taps, dim=0)
        combo = _deep_combo_evals([t.blocks for t in trees], trace_taps,
                                  check_evals,
                                  taps_check, beta, z_, zg, z4, n,
                                  ps.commit_expand)

    # --- FRI and the openings of every group at its query points ---
    with _stage("stark.fri", dev):
        fri_proof, indices = fri.prove(tr, combo, queries=ps.queries,
                                       min_degree=ps.fri_min_degree,
                                       inv_rate=ps.commit_expand,
                                       suite=suite)

        def open_group(tree):
            return GroupOpening(*merkle.open_rows(tree, indices))

        return SegmentProof(
            ctrl_root=ctrl_tree.root if has_ctrl else None,
            data_root=data_tree.root,
            accum_root=accum_tree.root if has_accum else None,
            check_root=check_tree.root,
            taps_ctrl=taps_ctrl,
            taps_data=taps_data,
            taps_accum=taps_accum,
            taps_check=taps_check,
            open_ctrl=open_group(ctrl_tree) if has_ctrl else None,
            open_data=open_group(data_tree),
            open_accum=open_group(accum_tree) if has_accum else None,
            open_check=open_group(check_tree),
            fri_proof=fri_proof,
        )


def _deep_combo_evals(trace_blocks, trace_taps, check_evals, taps_check,
                      beta, z, zg, z4, n: int, commit_expand: int):
    """combo(x) = Σ_p (Σ_{j∈p} β^j P_j(x) - Σ_{j∈p} β^j v_j) / (x - p),
    all on the commit domain g*H_{commit_expand*N}. `trace_blocks`: the
    trees' evaluation matrices (ctrl, data, accum) as each tree's column
    blocks, read in place."""
    dev = check_evals.device
    big = commit_expand * n
    ct = sum(b.shape[1] for tree in trace_blocks for b in tree)
    betas = NTT.ext_powers(beta, 2 * ct + CHECK_COLS)
    w_z, w_zg, w_check = betas[:ct], betas[ct: 2 * ct], betas[2 * ct:]

    xs = _tensor(_commit_xs(n, commit_expand), dev)
    points = torch.stack([z, zg, z4])
    dens = F.ext_sub(F.ext_from_base(xs)[None], points[:, None, :].expand(
        3, big, EXT))
    inv_dens = F.ext_inv(dens)  # (3, cN, 4)

    # z- and zg-weighted sums read the same matrices: one 8-wide weighted sum
    s_both = _trace_sums(trace_blocks, torch.cat([w_z, w_zg], 1))
    sums = (s_both[:, :EXT], s_both[:, EXT:],
            bbmm.bb_weighted_sum(check_evals, w_check))

    combo = torch.zeros((big, EXT), dtype=F.I32, device=dev)
    for i, (weights, taps, s) in enumerate((
            (w_z, trace_taps[:, 0], sums[0]),
            (w_zg, trace_taps[:, 1], sums[1]),
            (w_check, taps_check, sums[2]))):
        cp = F.sum_mod(F.ext_mul(weights, taps), 0)
        num = F.ext_sub(s, cp.expand(s.shape))
        combo = F.ext_add(combo, F.ext_mul(num, inv_dens[i]))
    return combo


def _trace_sums(trace_blocks, weights):
    """Σ_j weights[j] P_j(x) over the trees' columns in order ((cN, W)
    on the leader). Block k of every tree is position k of its tp group:
    each position sums its own blocks on its own device against its rows
    of `weights`, and the leader adds the (cN, W) partial sums mod P (the
    sums are exact, so this is the one-device sum word for word)."""
    by_pos, off = {}, 0
    for tree in trace_blocks:
        for k, b in enumerate(tree):
            by_pos.setdefault(k, ([], []))
            by_pos[k][0].append(b)
            by_pos[k][1].append(weights[off: off + b.shape[1]])
            off += b.shape[1]
    if len(by_pos) == 1:
        return bbmm.bb_weighted_sum_blocks(by_pos[0][0], weights)
    total = None
    for k, (blocks, rows) in by_pos.items():
        w = torch.cat(rows, 0)
        part = bbmm.bb_weighted_sum_blocks(
            blocks, w if k == 0 else sharded.move(w, blocks[0].device))
        part = part if k == 0 else sharded.move(part, weights.device)
        total = part if total is None else F.add(total, part)
    return total


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


def verify(air: Air, proof: SegmentProof, pub, po2: int,
           control_root=None, ps: ProofSystem = ProofSystem()):
    """Verify a SegmentProof; returns a 0-d bool tensor.

    `control_root`: the circuit's ctrl-group Merkle root (the program's
    image id), required iff the AIR has ctrl columns."""
    n = 1 << po2
    big = ps.commit_expand * n
    has_ctrl = air.ctrl_cols > 0
    has_accum = air.accum_cols > 0
    dev = proof.data_root.device

    suite = ps.suite()
    tr = suite.transcript(dev)
    tr.mix_pub(pub)
    if has_ctrl:
        assert control_root is not None
        tr.mix_digest(control_root)
    tr.mix_digest(proof.data_root)
    globals_ = (torch.stack([tr.sample_ext() for _ in range(air.globals_count)])
                if air.globals_count else torch.zeros((0, EXT), dtype=F.I32,
                                                      device=dev))
    if has_accum:
        tr.mix_digest(proof.accum_root)
    alpha = tr.sample_ext()
    tr.mix_digest(proof.check_root)
    z = tr.sample_ext()
    z_, zg, z4 = _deep_points(z, n)

    all_taps = [t for t in (proof.taps_ctrl, proof.taps_data,
                            proof.taps_accum) if t is not None]
    tr.mix_elems(torch.cat([t.reshape(-1) for t in all_taps]
                           + [proof.taps_check.reshape(-1)]))
    beta = tr.sample_ext()

    # --- ALI check at z ---
    def taps_cols(o):
        return Columns(
            ctrl=TapAccessor(proof.taps_ctrl, o) if has_ctrl else None,
            data=TapAccessor(proof.taps_data, o),
            accum=TapAccessor(proof.taps_accum, o) if has_accum else None)

    cons = air.constraints(ExtAlg(dev), taps_cols(0), taps_cols(1),
                           globals_, pub)
    zk = air.zk_rows(po2)
    if zk:
        # Z_H * Q == A_trans + A_point * P_Z (point class: real rows only)
        zc = getattr(air, "_zclass", None)
        assert zc is not None and len(zc) == len(cons)
        comb_t = combine_constraints(cons, alpha, at_deep=True, keep=zc)
        comb_p = combine_constraints(cons, alpha, at_deep=True,
                                     keep=[not t for t in zc])
        pz = F.ext_ones((), dev)
        for r in _zk_root_ints(n, zk):
            pz = F.ext_mul(pz, F.ext_sub(z_, F.ext_from_base(F.const(r, dev))))
        combined = F.ext_add(comb_t, F.ext_mul(comb_p, pz))
    else:
        combined = combine_constraints(cons, alpha, at_deep=True)
    zz = F.ext_sub(F.ext_pow_const(z_, n), F.ext_ones((), dev))  # z^N - 1
    qs = _recombine_check_taps(proof.taps_check)
    q_at_z = F.sum_mod(F.ext_mul(NTT.ext_powers(z_, CHECK_SPLIT), qs), 0)
    ok = torch.all(combined == F.ext_mul(zz, q_at_z))

    # --- FRI + query checks ---
    fri_ok, indices, round0 = fri.verify(
        tr, proof.fri_proof, big, queries=ps.queries,
        min_degree=ps.fri_min_degree, inv_rate=ps.commit_expand, suite=suite)
    ok = ok & fri_ok

    roots_openings = [(proof.check_root, proof.open_check)]
    if has_ctrl:
        roots_openings.append((control_root, proof.open_ctrl))
    roots_openings.append((proof.data_root, proof.open_data))
    if has_accum:
        roots_openings.append((proof.accum_root, proof.open_accum))
    for root, opening in roots_openings:
        ok = ok & torch.all(suite.verify_rows(root, indices, opening.rows,
                                              opening.paths))

    # Recompute combo at the query points from the opened rows
    # (group order as in the prover: ctrl, data, accum).
    parts = ([proof.open_ctrl.rows] if has_ctrl else []) + \
        [proof.open_data.rows] + ([proof.open_accum.rows] if has_accum else [])
    trace_rows = torch.cat(parts, dim=1)
    trace_taps = torch.cat(all_taps, dim=0)
    ct = trace_rows.shape[1]
    betas = NTT.ext_powers(beta, 2 * ct + CHECK_COLS)
    x_at = _tensor(_commit_xs(n, ps.commit_expand), dev)[indices]
    points = torch.stack([z_, zg, z4])
    dens = F.ext_sub(F.ext_from_base(x_at)[None],
                     points[:, None, :].expand(3, ps.queries, EXT))
    inv_dens = F.ext_inv(dens)
    expected = torch.zeros((ps.queries, EXT), dtype=F.I32, device=dev)
    for i, (weights, rows, taps) in enumerate((
            (betas[:ct], trace_rows, trace_taps[:, 0]),
            (betas[ct: 2 * ct], trace_rows, trace_taps[:, 1]),
            (betas[2 * ct:], proof.open_check.rows, proof.taps_check))):
        s = bbmm.bb_weighted_sum(rows, weights)
        cp = F.sum_mod(F.ext_mul(weights, taps), 0)
        num = F.ext_sub(s, cp.expand(s.shape))
        expected = F.ext_add(expected, F.ext_mul(num, inv_dens[i]))
    return ok & torch.all(expected == round0)


def control_root_of(air: Air, po2: int, ctrl_trace=None,
                    ps: ProofSystem = ProofSystem(), device="cuda"):
    """The circuit's control ID: Merkle root of the ctrl group commitment,
    computed on the device of `ctrl_trace` (else on `device`, the card
    unless the caller asks for the CPU).

    For rv32im this is the program's image id; it depends on
    ps.commit_expand (the commitment domain is part of the identity)."""
    if ctrl_trace is None:
        ctrl_trace = air.ctrl_trace(1 << po2, device)
    return _lde_commit(ctrl_trace, ps.commit_expand, ps.suite())[2].root
