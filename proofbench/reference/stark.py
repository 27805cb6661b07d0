"""DEEP-ALI STARK verifier over Baby Bear, plain torch.

Frozen copy of the verifier half of `boundless_tpu_torch/prover/stark.py`
(its transcript schedule, ALI check at z, FRI and query checks) and of
`control_root_of`, with the port's kernels replaced by plain torch: the
benchmark's judge of a segment or recursion proof, and the source of a
program's image id (the ctrl group's Merkle root).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import field as F
from . import fri, merkle
from . import ntt as NTT
from .ntt import _powers as _np_powers
from .dsl import Columns, ExtAlg
from .transcript import Transcript

INV_RATE = 4
EXT = 4
CHECK_SPLIT = 4  # composition split factor
CHECK_COLS = CHECK_SPLIT * EXT  # 16 base columns


class ProofSystem(NamedTuple):
    """The STARK parameters a proof is verified under."""

    queries: int
    fri_min_degree: int
    commit_expand: int = 2


def _tensor(a: np.ndarray, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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
        raise ValueError("the verifier combines at the DEEP point only")

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


def _coset_np(n: int, expand: int) -> np.ndarray:
    """Canonical points g*H_{expand*N} (int64)."""
    big = expand * n
    return _np_powers(F.ROU_FWD[big.bit_length() - 1], big) * F.GENERATOR % F.P


@functools.lru_cache(maxsize=None)
def _commit_xs(n: int, expand: int) -> np.ndarray:
    """Commit-domain points g*H_{expand*N} (Montgomery int32)."""
    return F.mont_np(_coset_np(n, expand)).astype(np.int32)


def _zk_root_ints(n: int, zk: int) -> list:
    """The blinded-tail trace points w_N^j, j = n-zk..n-1 (canonical)."""
    wn = F.ROU_FWD[n.bit_length() - 1]
    return [pow(wn, j, F.P) for j in range(n - zk, n)]


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


class _TapAccessor:
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


def verify(air, proof, pub, po2: int, control_root, ps: ProofSystem):
    """Verify a SegmentProof; returns a 0-d bool tensor.

    `control_root`: the circuit's ctrl-group Merkle root (the program's
    image id), required iff the AIR has ctrl columns."""
    n = 1 << po2
    big = ps.commit_expand * n
    has_ctrl = air.ctrl_cols > 0
    has_accum = air.accum_cols > 0
    dev = proof.data_root.device

    tr = Transcript(dev)
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
            ctrl=_TapAccessor(proof.taps_ctrl, o) if has_ctrl else None,
            data=_TapAccessor(proof.taps_data, o),
            accum=_TapAccessor(proof.taps_accum, o) if has_accum else None)

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
        min_degree=ps.fri_min_degree, inv_rate=ps.commit_expand)
    ok = ok & fri_ok

    roots_openings = [(proof.check_root, proof.open_check)]
    if has_ctrl:
        roots_openings.append((control_root, proof.open_ctrl))
    roots_openings.append((proof.data_root, proof.open_data))
    if has_accum:
        roots_openings.append((proof.accum_root, proof.open_accum))
    for root, opening in roots_openings:
        ok = ok & torch.all(merkle.verify_rows(root, indices, opening.rows,
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
        s = F.weighted_sum(rows, weights)
        cp = F.sum_mod(F.ext_mul(weights, taps), 0)
        num = F.ext_sub(s, cp.expand(s.shape))
        expected = F.ext_add(expected, F.ext_mul(num, inv_dens[i]))
    return ok & torch.all(expected == round0)


def control_root_of(air, po2: int, ctrl_trace, ps: ProofSystem):
    """The circuit's control ID: Merkle root of the ctrl group's LDE on
    the commit domain g*H_{cN} (for rv32im, the program's image id)."""
    coeffs = NTT.interpolate(ctrl_trace)
    evals = NTT.coset_evaluate(coeffs, expand=ps.commit_expand)
    return merkle.commit(evals).root
