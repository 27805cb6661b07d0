"""Sparse Groth16 engine: FFT-domain QAP, CRS setup, prover.

`protocol.py` holds the textbook dense/Lagrange engine (fine for toy
circuits and kept for tests); this module is the production-shaped path
for the wrap circuit's ~10^5-10^6 constraints (groth16/circuit.py):

  * evaluation domain = the 2^k multiplicative subgroup of Fr (BN254's
    2-adicity is 28), Lagrange values L_k(tau) in closed form with one
    batched inversion — O(m) setup per domain point;
  * QAP division via one coset NTT: H = (A.s * B.s - C.s) / Z evaluated
    on a shifted copy of the domain (Z is constant there), O(m log m);
  * per-variable CRS points via sparse iteration over constraint rows.

Counterpart of `boundless_tpu/groth16/qap.py`, copied, except the MSM
dispatch: `msm_pippenger` takes the prover's `device` in place of the
reference's backend test and `BT_MSM_DEVICE`. On the card, from
`PIPPENGER_MIN_POINTS` points up, every MSM launches the CUDA Pippenger
(`groth16/msm_device.py`, `csrc/msm.cu`); below that, and on the CPU, it
runs the host Pippenger (msm.py). Reference shape: snarkjs/rapidsnark
zkey + prover behind `blake3_groth16`.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import List, Optional, Sequence, Tuple

from .bn254 import G1, R
from .msm import msm_pippenger as _msm_host
from . import pairing as PR
from .protocol import Proof, ProvingKey, VerifyingKey
from .r1cs import SparseR1CS


# The reference's device threshold (`msm_tpu.py:286`): below it the
# host Pippenger runs on every device.
PIPPENGER_MIN_POINTS = 64


def msm_pippenger(points, scalars, device="cpu"):
    """G1 MSM dispatch: the CUDA Pippenger on a CUDA `device` from
    PIPPENGER_MIN_POINTS points up (the CUDA MSM's role in the reference,
    `blake3_groth16/src/prove/cuda.rs:40`), the host Pippenger otherwise.
    On the card `points` should be one list kept for many calls (a
    ProvingKey's): its limb tensor is built once and cached."""
    import torch

    if (torch.device(device).type == "cuda"
            and len(points) >= PIPPENGER_MIN_POINTS):
        from . import msm_device

        return msm_device.msm(points, scalars, device)
    return _msm_host(points, scalars)

TWO_ADICITY = 28
# multiplicative generator of Fr* is 5 (standard for BN254 scalar field)
_GEN = 5
_ROOT = pow(_GEN, (R - 1) >> TWO_ADICITY, R)


def _omega(logm: int) -> int:
    return pow(_ROOT, 1 << (TWO_ADICITY - logm), R)


def ntt(vals: List[int], invert: bool = False) -> List[int]:
    """In-place iterative radix-2 NTT over Fr (length a power of two)."""
    a = [v % R for v in vals]
    n = len(a)
    logn = n.bit_length() - 1
    assert 1 << logn == n
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w = _omega(length.bit_length() - 1)
        if invert:
            w = pow(w, R - 2, R)
        half = length >> 1
        for start in range(0, n, length):
            wn = 1
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * wn % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
                wn = wn * w % R
        length <<= 1
    if invert:
        ninv = pow(n, R - 2, R)
        a = [x * ninv % R for x in a]
    return a


def _batch_inv(vals: List[int]) -> List[int]:
    """Montgomery batch inversion (zero maps to zero)."""
    pref = []
    acc = 1
    for v in vals:
        pref.append(acc)
        if v:
            acc = acc * v % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = pref[i] * inv % R
            inv = inv * vals[i] % R
    return out


def _lagrange_at(tau: int, m: int) -> List[int]:
    """L_k(tau) for the size-m subgroup domain: L_k(tau) =
    omega^k (tau^m - 1) / (m (tau - omega^k))."""
    w = _omega(m.bit_length() - 1)
    zt = (pow(tau, m, R) - 1) % R
    minv = pow(m, R - 2, R)
    wk = 1
    dens = []
    wks = []
    for _ in range(m):
        wks.append(wk)
        dens.append((tau - wk) % R)
        wk = wk * w % R
    dinvs = _batch_inv(dens)
    return [wks[k] * zt % R * minv % R * dinvs[k] % R for k in range(m)]


def _var_evals_at_tau(rows, col_of, n_vars: int, ltau: List[int]
                      ) -> List[int]:
    """Sparse A_i(tau) = sum_k rows[k][i] * L_k(tau)."""
    out = [0] * n_vars
    for k, row in enumerate(rows):
        lk = ltau[k]
        if not lk:
            continue
        for i, coef in col_of(row).items():
            out[i] = (out[i] + coef * lk) % R
    return out


@dataclasses.dataclass
class Trapdoor:
    """The dev-CRS toxic waste. With it, proving collapses to O(nnz)
    scalar arithmetic + 5 group exponentiations (prove_with_trapdoor) —
    the produced proof is BIT-FOR-BIT the same distribution as the MSM
    prover's, and verification stays the real pairing check. This is the
    dev-mode analogue of the reference's locally-generated zkey
    (production swaps in a ceremony CRS and the MSM path)."""

    tau: int
    alpha: int
    beta: int
    gamma: int
    delta: int
    m: int  # QAP domain size


def setup_sparse(sys_: SparseR1CS, rng=secrets.randbelow,
                 progress=None) -> Tuple[ProvingKey, VerifyingKey]:
    """Dev CRS (local toxic waste) for a sparse system, FFT-domain QAP."""
    m = 1 << max(1, (len(sys_.rows) - 1).bit_length())
    tau = rng(R - 1) + 1
    alpha = rng(R - 1) + 1
    beta = rng(R - 1) + 1
    gamma = rng(R - 1) + 1
    delta = rng(R - 1) + 1
    ltau = _lagrange_at(tau, m)
    a_tau = _var_evals_at_tau(sys_.rows, lambda r: r[0], sys_.n_vars, ltau)
    b_tau = _var_evals_at_tau(sys_.rows, lambda r: r[1], sys_.n_vars, ltau)
    c_tau = _var_evals_at_tau(sys_.rows, lambda r: r[2], sys_.n_vars, ltau)
    z_tau = (pow(tau, m, R) - 1) % R
    g1 = G1.generator()
    g2 = PR.g2_generator()
    ginv = pow(gamma, R - 2, R)
    dinv = pow(delta, R - 2, R)
    npub1 = 1 + sys_.n_pub

    def lval(i):
        return (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) % R

    if progress:
        progress("crs: G1 exponentiations")
    g1m = _FixedBaseG1(g1)
    a_g1 = [g1m.mul(v) for v in a_tau]
    b_g1 = [g1m.mul(v) for v in b_tau]
    l_g1 = [g1m.mul(lval(i) * dinv % R)
            for i in range(npub1, sys_.n_vars)]
    # H basis: [tau^j * Z(tau) / delta]_1, j <= m - 2
    h_g1 = []
    cur = z_tau * dinv % R
    for _ in range(m - 1):
        h_g1.append(g1m.mul(cur))
        cur = cur * tau % R
    if progress:
        progress("crs: G2 exponentiations")
    b_g2 = [PR.g2_mul(g2, v) if v else PR.g2_mul(g2, 0) for v in b_tau]
    pk = ProvingKey(
        alpha_g1=g1m.mul(alpha), beta_g1=g1m.mul(beta),
        delta_g1=g1m.mul(delta),
        beta_g2=PR.g2_mul(g2, beta), delta_g2=PR.g2_mul(g2, delta),
        a_g1=a_g1, b_g1=b_g1, b_g2=b_g2, l_g1=l_g1, h_g1=h_g1)
    vk = VerifyingKey(
        alpha_g1=g1m.mul(alpha), beta_g2=PR.g2_mul(g2, beta),
        gamma_g2=PR.g2_mul(g2, gamma), delta_g2=PR.g2_mul(g2, delta),
        ic=[g1m.mul(lval(i) * ginv % R) for i in range(npub1)])
    return pk, vk


class _FixedBaseG1:
    """Windowed fixed-base G1 scalar multiplication (8-bit windows)."""

    W = 8

    def __init__(self, base: G1):
        self.tables = []
        cur = base
        for _ in range(-(-254 // self.W)):
            row = [G1.infinity()]
            for _i in range((1 << self.W) - 1):
                row.append(row[-1].add(cur))
            self.tables.append(row)
            cur = row[-1].add(cur)  # base * 2^W

    def mul(self, scalar: int) -> G1:
        s = scalar % R
        acc = G1.infinity()
        for t in self.tables:
            if s == 0:
                break
            d = s & ((1 << self.W) - 1)
            if d:
                acc = acc.add(t[d])
            s >>= self.W
        return acc


def setup_trapdoor(sys_: SparseR1CS, rng=secrets.randbelow
                   ) -> Tuple[Trapdoor, VerifyingKey]:
    """Trapdoor-only dev setup: O(n_pub * nnz) — no per-variable CRS
    points are materialized (prove_with_trapdoor needs none)."""
    m = 1 << max(1, (len(sys_.rows) - 1).bit_length())
    td = Trapdoor(tau=rng(R - 1) + 1, alpha=rng(R - 1) + 1,
                  beta=rng(R - 1) + 1, gamma=rng(R - 1) + 1,
                  delta=rng(R - 1) + 1, m=m)
    ltau = _lagrange_at(td.tau, m)
    npub1 = 1 + sys_.n_pub
    a_tau = [0] * npub1
    b_tau = [0] * npub1
    c_tau = [0] * npub1
    for k, row in enumerate(sys_.rows):
        lk = ltau[k]
        if not lk:
            continue
        for out, lc in zip((a_tau, b_tau, c_tau), row):
            for i, coef in lc.items():
                if i < npub1:
                    out[i] = (out[i] + coef * lk) % R
    g1 = G1.generator()
    g2 = PR.g2_generator()
    ginv = pow(td.gamma, R - 2, R)
    vk = VerifyingKey(
        alpha_g1=g1.mul(td.alpha), beta_g2=PR.g2_mul(g2, td.beta),
        gamma_g2=PR.g2_mul(g2, td.gamma),
        delta_g2=PR.g2_mul(g2, td.delta),
        ic=[g1.mul((td.beta * a_tau[i] + td.alpha * b_tau[i] + c_tau[i])
                   % R * ginv % R) for i in range(npub1)])
    return td, vk


def prove_with_trapdoor(sys_: SparseR1CS, td: Trapdoor, s: Sequence[int],
                        rng=secrets.randbelow, check: bool = False
                        ) -> Proof:
    """Groth16 prove using the dev trapdoor: evaluate the QAP at tau as
    SCALARS (per-row dot + Lagrange), then five exponentiations. Output
    distribution identical to the MSM prover."""
    if check:
        assert sys_.is_satisfied(s)
    m = td.m
    ltau = _lagrange_at(td.tau, m)
    a_val = b_val = c_val = 0
    npub1 = 1 + sys_.n_pub
    a_pub = b_pub = c_pub = 0
    for k, row in enumerate(sys_.rows):
        lk = ltau[k]
        if not lk:
            continue
        dots = []
        pubdots = []
        for lc in row:
            acc = 0
            accp = 0
            for i, coef in lc.items():
                t = coef * s[i]
                acc += t
                if i < npub1:
                    accp += t
            dots.append(acc % R)
            pubdots.append(accp % R)
        a_val = (a_val + dots[0] * lk) % R
        b_val = (b_val + dots[1] * lk) % R
        c_val = (c_val + dots[2] * lk) % R
        a_pub = (a_pub + pubdots[0] * lk) % R
        b_pub = (b_pub + pubdots[1] * lk) % R
        c_pub = (c_pub + pubdots[2] * lk) % R
    z_tau = (pow(td.tau, m, R) - 1) % R
    h_val = (a_val * b_val - c_val) % R * pow(z_tau, R - 2, R) % R
    r = rng(R)
    t = rng(R)
    dinv = pow(td.delta, R - 2, R)
    a_sc = (td.alpha + a_val + r * td.delta) % R
    b_sc = (td.beta + b_val + t * td.delta) % R
    wit_l = ((td.beta * (a_val - a_pub) + td.alpha * (b_val - b_pub)
              + (c_val - c_pub)) % R) * dinv % R
    c_sc = (wit_l + h_val * z_tau % R * dinv
            + t * a_sc + r * b_sc - r * t % R * td.delta) % R
    g1 = G1.generator()
    g2 = PR.g2_generator()
    return Proof(a=g1.mul(a_sc), b=PR.g2_mul(g2, b_sc), c=g1.mul(c_sc))


def _row_evals(sys_: SparseR1CS, s: Sequence[int], m: int):
    """Per-constraint-row dot products (A.s, B.s, C.s), padded to m."""
    outs = ([0] * m, [0] * m, [0] * m)
    for k, row in enumerate(sys_.rows):
        for out, lc in zip(outs, row):
            acc = 0
            for i, coef in lc.items():
                acc += coef * s[i]
            out[k] = acc % R
    return outs


def prove_sparse(sys_: SparseR1CS, pk: ProvingKey, s: Sequence[int],
                 rng=secrets.randbelow, check: bool = False,
                 progress=None, device="cuda") -> Proof:
    """Groth16 prover over a sparse system (coset-NTT QAP division); the
    four G1 MSMs run on `device` (the card unless the caller asks for the
    CPU)."""
    from ..zkvm.prove import _device

    device = _device(device)
    if check:
        assert sys_.is_satisfied(s)
    m = len(pk.h_g1) + 1
    if progress:
        progress("qap: row evaluations")
    av, bv, cv = _row_evals(sys_, s, m)
    if progress:
        progress("qap: coset NTTs")
    # interpolate, evaluate on the coset shift*H (Z(shift*w^i) constant)
    shift = _GEN
    ac = ntt(av, invert=True)
    bc = ntt(bv, invert=True)
    cc = ntt(cv, invert=True)

    def to_coset(coeffs):
        sc = []
        cur = 1
        for co in coeffs:
            sc.append(co * cur % R)
            cur = cur * shift % R
        return ntt(sc)

    ae, be, ce = to_coset(ac), to_coset(bc), to_coset(cc)
    zc_inv = pow((pow(shift, m, R) - 1) % R, R - 2, R)
    he = [(a * b - c) % R * zc_inv % R for a, b, c in zip(ae, be, ce)]
    hc = ntt(he, invert=True)
    sinv = pow(shift, R - 2, R)
    cur = 1
    h = []
    for co in hc:
        h.append(co * cur % R)
        cur = cur * sinv % R
    assert all(x == 0 for x in h[m - 1 :]), "H degree exceeds CRS"
    h = h[: m - 1]

    r = rng(R)
    t = rng(R)
    npub1 = 1 + sys_.n_pub
    if progress:
        progress("msm: A/B/C")
    a_pt = pk.alpha_g1.add(msm_pippenger(pk.a_g1, list(s), device)) \
        .add(pk.delta_g1.mul(r))
    b_g1 = pk.beta_g1.add(msm_pippenger(pk.b_g1, list(s), device)) \
        .add(pk.delta_g1.mul(t))
    b_pt = pk.beta_g2
    for pt, coef in zip(pk.b_g2, s):
        if coef:
            b_pt = PR.g2_add(b_pt, PR.g2_mul(pt, coef))
    b_pt = PR.g2_add(b_pt, PR.g2_mul(pk.delta_g2, t))
    c_pt = (msm_pippenger(pk.l_g1, list(s[npub1:]), device)
            if len(s) > npub1 else G1.infinity())
    c_pt = c_pt.add(msm_pippenger(pk.h_g1, h + [0] * (m - 1 - len(h)),
                                   device))
    c_pt = c_pt.add(a_pt.mul(t)).add(b_g1.mul(r)) \
        .add(pk.delta_g1.mul((-r * t) % R))
    return Proof(a=a_pt, b=b_pt, c=c_pt)
