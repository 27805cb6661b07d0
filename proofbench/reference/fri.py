"""FRI low-degree test over Baby Bear's quartic extension.

Frozen copy of `boundless_tpu_torch/core/fri.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/core/fri.py`: fold factor 16 (four radix-2
folds with alpha, alpha^2, alpha^4, alpha^8), each round committed as a
Merkle matrix whose row r holds the 16 coset-group values {r + t*M/16};
the verifier recomputes each fold at the query points with the direct
formula. Round k lives on the coset shift_k * H_{M_k}.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from . import merkle
from .ntt import _powers as _np_powers

FRI_FOLD = 16
FRI_FOLD_LOG = 4
QUERIES = 50
FRI_MIN_DEGREE = 256
INV_RATE = 4


@functools.lru_cache(maxsize=None)
def _domain_inv_np(m: int, shift: int) -> np.ndarray:
    """x_i^{-1} = shift^{-1} w^{-i} on the coset shift*H_m (Montgomery)."""
    w_inv = F.ROU_REV[m.bit_length() - 1]
    shift_inv = pow(shift, F.P - 2, F.P)
    return F.mont_np(_np_powers(w_inv, m) * shift_inv % F.P).astype(np.int32)


def _domain_inv_table(m: int, shift: int, device):
    return torch.from_numpy(_domain_inv_np(m, shift)).to(device)


def num_rounds(m: int, min_degree: int = FRI_MIN_DEGREE,
               inv_rate: int = INV_RATE) -> int:
    rounds = 0
    degree = m // inv_rate
    while degree > min_degree:
        rounds += 1
        degree //= FRI_FOLD
    return rounds


def verify(tr, proof: FriProof, m: int, queries: int = QUERIES,
           min_degree: int = FRI_MIN_DEGREE, inv_rate: int = INV_RATE):
    """Replay the transcript and check the FRI proof.

    Returns (ok, indices, round0_values): round0_values[q] is the committed
    value of the tested polynomial at query q, for the DEEP-ALI check."""
    rounds = num_rounds(m, min_degree, inv_rate)
    assert len(proof.round_roots) == rounds
    dev = proof.final_coeffs.device
    alphas = []
    for root in proof.round_roots:
        tr.mix_digest(root)
        alphas.append(tr.sample_ext())
    tr.mix_elems(proof.final_coeffs)
    indices = tr.sample_indices(queries, m.bit_length() - 1)

    ok = torch.ones((), dtype=torch.bool, device=dev)
    idx, cur_m, cur_shift = indices, m, F.GENERATOR
    value = round0 = None
    inv16 = F.const(pow(FRI_FOLD, F.P - 2, F.P), dev)
    for k in range(rounds):
        rows_n = cur_m // FRI_FOLD
        r = idx % rows_n
        t_pos = idx // rows_n  # which of the 16 group slots is our point
        rows = proof.round_rows[k]
        ok = ok & torch.all(merkle.verify_rows(proof.round_roots[k], r, rows,
                                              proof.round_paths[k]))
        group = rows.reshape(-1, FRI_FOLD, 4)
        mine = torch.gather(group, 1, t_pos[:, None, None].expand(-1, 1, 4))[:, 0]
        if value is None:
            round0 = mine
        else:
            ok = ok & torch.all(mine == value)
        inv_tbl = _domain_inv_table(cur_m, cur_shift, dev)
        pos = r[:, None] + torch.arange(FRI_FOLD, device=dev)[None, :] * rows_n
        ax = F.ext_scale(alphas[k].expand(queries, FRI_FOLD, 4), inv_tbl[pos])
        # s_t = Σ_{j<16} (alpha/x_t)^j = (1+p)(1+p^2)(1+p^4)(1+p^8)
        s = F.ext_ones((queries, FRI_FOLD), dev)
        p = ax
        for _ in range(FRI_FOLD_LOG):
            s = F.ext_add(s, F.ext_mul(s, p))
            p = F.ext_mul(p, p)
        value = F.mul(F.sum_mod(F.ext_mul(group, s), 1), inv16)
        idx, cur_m = r, rows_n
        cur_shift = pow(cur_shift, FRI_FOLD, F.P)

    # Final check: the final polynomial at the surviving points.
    w = F.ROU_FWD[cur_m.bit_length() - 1]
    xs = torch.from_numpy(F.mont_np(_np_powers(w, cur_m) * cur_shift % F.P
                                    ).astype(np.int32)).to(dev)
    x_at = xs[idx]
    acc = torch.zeros((queries, 4), dtype=F.I32, device=dev)
    for d in range(proof.final_coeffs.shape[0] - 1, -1, -1):
        acc = F.ext_add(F.ext_scale(acc, x_at),
                        proof.final_coeffs[d].expand(queries, 4))
    ok = ok & torch.all(acc == value)
    return ok, indices, round0
