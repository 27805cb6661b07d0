"""Groth16 over BN254: R1CS -> QAP, CRS setup, prove (MSM), verify (pairing).

Reference flow: `blake3_groth16/src/prove.rs` (witness -> rapidsnark/CUDA
Groth16) and `src/verify.rs:63-124` (ark-bn254 verifier), SURVEY.md §2.4.
Counterpart of `boundless_tpu/groth16/protocol.py`, copied: the
protocol engine for that wrap; the prover is MSM-shaped (msm.py, host),
the verifier a 4-term pairing-product check (pairing.py, host).

The CRS here is generated from local randomness ("powers of tau" known to
the setup caller) — a *dev CRS*: sound for self-generated proofs and for
tests, NOT a production ceremony.  Wire compatibility with the
reference's circuit-specific CRS (snarkjs zkey) is a later-round item;
the proving/verifying equations are the standard Groth16 ones, so only
the CRS ingestion differs.

R1CS convention: variables s = (1, pub..., wit...); constraints
(A_k . s) * (B_k . s) = (C_k . s).  QAP over the scalar field R with the
evaluation domain {1..m}.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import List, Sequence

from .bn254 import G1, R
from .msm import msm_pippenger
from . import pairing as PR

# ---------------------------------------------------------------------------
# Polynomial helpers over the scalar field R (dense coefficient lists,
# lowest degree first).  Sizes here are tiny (toy circuits / wrap glue);
# the hot MSMs are the group operations, not these.
# ---------------------------------------------------------------------------


def _poly_add(a, b):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R
            for i in range(n)]


def _poly_scale(a, k):
    return [x * k % R for x in a]


def _poly_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if not x:
            continue
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % R
    return out


def _poly_eval(a, x):
    acc = 0
    for c in reversed(a):
        acc = (acc * x + c) % R
    return acc


def _lagrange_basis(points: Sequence[int]) -> List[List[int]]:
    """L_i(X) with L_i(points[j]) = [i == j]."""
    out = []
    for i, xi in enumerate(points):
        num = [1]
        den = 1
        for j, xj in enumerate(points):
            if i == j:
                continue
            num = _poly_mul(num, [(-xj) % R, 1])
            den = den * ((xi - xj) % R) % R
        out.append(_poly_scale(num, pow(den, R - 2, R)))
    return out


def _vanishing(points: Sequence[int]) -> List[int]:
    z = [1]
    for xj in points:
        z = _poly_mul(z, [(-xj) % R, 1])
    return z


def _poly_divmod(a, b):
    a = list(a)
    binv = pow(b[-1], R - 2, R)
    q = [0] * max(len(a) - len(b) + 1, 0)
    for i in range(len(a) - len(b), -1, -1):
        c = a[i + len(b) - 1] * binv % R
        q[i] = c
        for j, bc in enumerate(b):
            a[i + j] = (a[i + j] - c * bc) % R
    rem = a[: len(b) - 1]
    return q, rem


# ---------------------------------------------------------------------------
# R1CS / QAP
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class R1CS:
    """Sparse-ish R1CS: rows are dense lists over n_vars (tiny systems).

    Variable 0 is the constant 1; variables [1, 1+n_pub) are public.
    """

    n_vars: int
    n_pub: int
    a_rows: List[List[int]]
    b_rows: List[List[int]]
    c_rows: List[List[int]]

    def is_satisfied(self, s: Sequence[int]) -> bool:
        for ar, br, cr in zip(self.a_rows, self.b_rows, self.c_rows):
            av = sum(x * y for x, y in zip(ar, s)) % R
            bv = sum(x * y for x, y in zip(br, s)) % R
            cv = sum(x * y for x, y in zip(cr, s)) % R
            if av * bv % R != cv:
                return False
        return True


def _qap_polys(r1cs: R1CS):
    """Per-variable QAP polynomials (A_i, B_i, C_i) and the vanishing Z."""
    m = len(r1cs.a_rows)
    domain = list(range(1, m + 1))
    basis = _lagrange_basis(domain)
    zero = [0]

    def col_polys(rows):
        polys = [zero] * r1cs.n_vars
        for k, row in enumerate(rows):
            for i, coef in enumerate(row):
                if coef:
                    polys = list(polys)
                    polys[i] = _poly_add(polys[i],
                                         _poly_scale(basis[k], coef))
        return polys

    return (col_polys(r1cs.a_rows), col_polys(r1cs.b_rows),
            col_polys(r1cs.c_rows), _vanishing(domain))


# ---------------------------------------------------------------------------
# CRS
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProvingKey:
    alpha_g1: G1
    beta_g1: G1
    delta_g1: G1
    beta_g2: tuple
    delta_g2: tuple
    a_g1: List[G1]  # [A_i(tau)]_1 per variable
    b_g1: List[G1]  # [B_i(tau)]_1 per variable
    b_g2: List[tuple]  # [B_i(tau)]_2 per variable
    l_g1: List[G1]  # [(beta A_i + alpha B_i + C_i)(tau)/delta]_1, witness i
    h_g1: List[G1]  # [tau^j Z(tau)/delta]_1


@dataclasses.dataclass
class VerifyingKey:
    alpha_g1: G1
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: List[G1]  # [(beta A_i + alpha B_i + C_i)(tau)/gamma]_1, public i


@dataclasses.dataclass
class Proof:
    a: G1
    b: tuple  # G2
    c: G1


def setup(r1cs: R1CS, rng=secrets.randbelow):
    """Dev CRS from local randomness (tau, alpha, beta, gamma, delta)."""
    apolys, bpolys, cpolys, z = _qap_polys(r1cs)
    tau = rng(R - 1) + 1
    alpha = rng(R - 1) + 1
    beta = rng(R - 1) + 1
    gamma = rng(R - 1) + 1
    delta = rng(R - 1) + 1
    g1 = G1.generator()
    g2 = PR.g2_generator()
    ginv = pow(gamma, R - 2, R)
    dinv = pow(delta, R - 2, R)

    a_tau = [_poly_eval(p, tau) for p in apolys]
    b_tau = [_poly_eval(p, tau) for p in bpolys]
    c_tau = [_poly_eval(p, tau) for p in cpolys]
    z_tau = _poly_eval(z, tau)
    npub1 = 1 + r1cs.n_pub  # constant-1 column counts as public

    def lval(i):
        return (beta * a_tau[i] + alpha * b_tau[i] + c_tau[i]) % R

    deg_h = len(z) - 2  # deg(H) <= m - 2
    pk = ProvingKey(
        alpha_g1=g1.mul(alpha), beta_g1=g1.mul(beta), delta_g1=g1.mul(delta),
        beta_g2=PR.g2_mul(g2, beta), delta_g2=PR.g2_mul(g2, delta),
        a_g1=[g1.mul(v) for v in a_tau],
        b_g1=[g1.mul(v) for v in b_tau],
        b_g2=[PR.g2_mul(g2, v) for v in b_tau],
        l_g1=[g1.mul(lval(i) * dinv % R) for i in range(npub1, r1cs.n_vars)],
        h_g1=[g1.mul(pow(tau, j, R) * z_tau % R * dinv % R)
              for j in range(deg_h + 1)],
    )
    vk = VerifyingKey(
        alpha_g1=g1.mul(alpha), beta_g2=PR.g2_mul(g2, beta),
        gamma_g2=PR.g2_mul(g2, gamma), delta_g2=PR.g2_mul(g2, delta),
        ic=[g1.mul(lval(i) * ginv % R) for i in range(npub1)],
    )
    return pk, vk


# ---------------------------------------------------------------------------
# Prove / verify
# ---------------------------------------------------------------------------


def prove(r1cs: R1CS, pk: ProvingKey, s: Sequence[int],
          rng=secrets.randbelow) -> Proof:
    """Standard Groth16 prover; group work is Pippenger MSMs (msm.py)."""
    assert r1cs.is_satisfied(s), "witness does not satisfy the R1CS"
    apolys, bpolys, cpolys, z = _qap_polys(r1cs)

    def combine(polys):
        acc = [0]
        for coef, p in zip(s, polys):
            if coef:
                acc = _poly_add(acc, _poly_scale(p, coef))
        return acc

    pa, pb, pc = combine(apolys), combine(bpolys), combine(cpolys)
    num = _poly_add(_poly_mul(pa, pb), _poly_scale(pc, R - 1))
    h, rem = _poly_divmod(num, z)
    assert all(x == 0 for x in rem), "QAP division has a remainder"

    r = rng(R)
    t = rng(R)
    npub1 = 1 + r1cs.n_pub
    wit = list(s[npub1:])

    a_pt = pk.alpha_g1.add(msm_pippenger(pk.a_g1, list(s))) \
        .add(pk.delta_g1.mul(r))
    b_g1 = pk.beta_g1.add(msm_pippenger(pk.b_g1, list(s))) \
        .add(pk.delta_g1.mul(t))
    b_pt = pk.beta_g2
    for pt, coef in zip(pk.b_g2, s):
        if coef:
            b_pt = PR.g2_add(b_pt, PR.g2_mul(pt, coef))
    b_pt = PR.g2_add(b_pt, PR.g2_mul(pk.delta_g2, t))

    c_pt = msm_pippenger(pk.l_g1, wit) if wit else G1.infinity()
    assert all(x == 0 for x in h[len(pk.h_g1):]), "H degree exceeds CRS"
    h = h[: len(pk.h_g1)]
    c_pt = c_pt.add(msm_pippenger(pk.h_g1, h + [0] * (len(pk.h_g1) - len(h))))
    c_pt = c_pt.add(a_pt.mul(t)).add(b_g1.mul(r)) \
        .add(pk.delta_g1.mul((-r * t) % R))
    return Proof(a=a_pt, b=b_pt, c=c_pt)


def verify(vk: VerifyingKey, proof: Proof, public: Sequence[int]) -> bool:
    """e(A,B) == e(alpha,beta) * e(IC(pub), gamma) * e(C, delta)."""
    assert len(public) == len(vk.ic) - 1, "public input length mismatch"
    ic = vk.ic[0]
    for pt, val in zip(vk.ic[1:], public):
        ic = ic.add(pt.mul(val % R))
    return PR.pairing_product_is_one([
        (proof.a.neg(), proof.b),
        (vk.alpha_g1, vk.beta_g2),
        (ic, vk.gamma_g2),
        (proof.c, vk.delta_g2),
    ])


# ---------------------------------------------------------------------------
# Example circuit used by tests and the wrap's dev path
# ---------------------------------------------------------------------------


def mul_circuit() -> R1CS:
    """Public z; prove knowledge of x, y with x*y = z and x + y public-free.

    Variables: (1, z, x, y, t) with constraints
        x * y = t
        t * 1 = z
    """
    n = 5
    z_ = [0] * n

    def row(**kw):
        out = list(z_)
        for k, v in kw.items():
            out[{"one": 0, "z": 1, "x": 2, "y": 3, "t": 4}[k]] = v % R
        return out

    return R1CS(
        n_vars=n, n_pub=1,
        a_rows=[row(x=1), row(t=1)],
        b_rows=[row(y=1), row(one=1)],
        c_rows=[row(t=1), row(z=1)],
    )
