"""BN254 pairing: Fp2/Fp6/Fp12 tower, G2, reduced Tate pairing.

Completes the curve layer for the STARK->SNARK wrap (reference
`risc0-groth16-sys` CUDA prover + ark-bn254 verifier in
`blake3_groth16/src/verify.rs:63-124`). Counterpart of
`boundless_tpu/groth16/pairing.py`, copied: the MSMs run on the card
(`groth16/msm_device.py`) and the *pairing check stays on the host* —
this module is that host side, in exact Python integers.

Tower (standard BN254 / alt_bn128, EIP-197 conventions):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 9 + u
    Fp12 = Fp6[w] / (w^2 - v)
G2 lives on the sextic twist E': y^2 = x^3 + 3/xi over Fp2; the lift
psi(x, y) = (x*w^2, y*w^3) embeds E'(Fp2) into E(Fp12) (y^2 = x^3 + 3).

The pairing here is the *reduced Tate pairing*
    e(P, Q) = f_{r,P}(psi(Q)) ^ ((p^12 - 1) / r)
with a plain double-and-add Miller loop over r.  Line functions have
Fp coefficients (P-side loop), so the loop body is one Fp12 square, one
sparse line evaluation, and one Fp12 multiply per bit — simple, exact,
and bilinear/non-degenerate on G1 x G2, which is all Groth16 needs when
the same pairing is used to set up, prove, and verify (protocol.py).
Wire-compatibility with external ark/snarkjs proofs needs the optimal
ate variant (shorter loop + Frobenius corrections) — staged; the tower
and final exponentiation here are shared by it.
"""

from __future__ import annotations

from .bn254 import B, G1, P, R

# ---------------------------------------------------------------------------
# Tower fields.  Elements are tuples of ints; all ops return canonical
# representatives mod P.  Fp2 = (a0, a1) = a0 + a1*u.
# ---------------------------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_sq(a):
    return f2_mul(a, a)


def f2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
    n = (a[0] * a[0] + a[1] * a[1]) % P
    ni = pow(n, P - 2, P)
    return (a[0] * ni % P, (-a[1]) * ni % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # the Fp6 non-residue 9 + u

# Fp6 = (c0, c1, c2) = c0 + c1*v + c2*v^2 with v^3 = XI.


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(
        f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))),
               f2_mul(a0, c0))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def _f6_mul_by_v(a):
    """a * v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_mul(XI, a[2]), a[0], a[1])


# Fp12 = (d0, d1) = d0 + d1*w with w^2 = v.


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c0 = f6_add(t0, _f6_mul_by_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])),
                       t0), t1)
    return (c0, c1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_inv(a):
    # 1/(d0 + d1 w) = (d0 - d1 w) / (d0^2 - v d1^2)
    t = f6_sub(f6_mul(a[0], a[0]), _f6_mul_by_v(f6_mul(a[1], a[1])))
    ti = f6_inv(t)
    return (f6_mul(a[0], ti), f6_mul(f6_neg(a[1]), ti))


F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sq(base)
        e >>= 1
    return out


def f12_eq(a, b):
    return a == b


# ---------------------------------------------------------------------------
# G2: affine points over Fp2 on the twist y^2 = x^3 + 3/xi.
# ---------------------------------------------------------------------------

B2 = f2_mul((B, 0), f2_inv(XI))  # 3 / (9 + u)

# Standard alt_bn128 G2 generator (EIP-197): x = x0 + x1*u, y = y0 + y1*u.
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sq(y), f2_add(f2_mul(f2_sq(x), x), B2)) == F2_ZERO


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], f2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sq(x1), 3),
                     f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sq(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R
    acc = None
    base = pt
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc


def g2_generator():
    assert g2_is_on_curve(G2_GEN)
    return G2_GEN


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------


def _psi(q):
    """Lift a twist point (Fp2 coords) to E(Fp12): (x*w^2, y*w^3).

    w^2 = v, w^3 = v*w; so x*w^2 = (0, x, 0 | 0) in the Fp6 c1 slot of
    d0, and y*w^3 = (0, y, 0) in the c1 slot of d1.
    """
    x, y = q
    xw2 = ((F2_ZERO, x, F2_ZERO), F6_ZERO)
    yw3 = (F6_ZERO, (F2_ZERO, y, F2_ZERO))
    return xw2, yw3


def _line_eval(a_x: int, a_y: int, lam, xq, yq):
    """l(Q) = yq - a_y - lam*(xq - a_x) for a line through (a_x, a_y) in
    E(Fp) with slope lam (an Fp int), evaluated at Q = (xq, yq) in Fp12.
    lam=None means the vertical line x = a_x."""
    ax = (((a_x, 0), F2_ZERO, F2_ZERO), F6_ZERO)
    if lam is None:
        return f12_add(xq, _f12_neg(ax))
    ay = (((a_y, 0), F2_ZERO, F2_ZERO), F6_ZERO)
    t = f12_add(xq, _f12_neg(ax))  # xq - a_x
    t = _f12_scalar(t, lam)
    return f12_add(f12_add(yq, _f12_neg(ay)), _f12_neg(t))


def _f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def _f12_scalar(a, k: int):
    return (tuple(f2_scalar(c, k) for c in a[0]),
            tuple(f2_scalar(c, k) for c in a[1]))


FINAL_EXP = (P ** 12 - 1) // R


def miller_loop(p_aff, q_lifted) -> tuple:
    """f_{r,P}(Q): double-and-add Miller loop over the group order r.

    p_aff: (x, y) ints, a G1 point.  q_lifted: psi(Q) in Fp12.
    """
    px, py = p_aff
    xq, yq = q_lifted
    f = F12_ONE
    tx, ty = px, py  # T = P, affine over Fp
    for bit in bin(R)[3:]:
        # tangent at T
        lam = 3 * tx * tx % P * pow(2 * ty % P, P - 2, P) % P
        f = f12_mul(f12_sq(f), _line_eval(tx, ty, lam, xq, yq))
        x3 = (lam * lam - 2 * tx) % P
        ty = (lam * (tx - x3) - ty) % P
        tx = x3
        if bit == "1":
            if tx == px:
                # T == P (doubling handled above) or T == -P (vertical)
                if (ty + py) % P == 0:
                    f = f12_mul(f, _line_eval(tx, ty, None, xq, yq))
                    tx, ty = None, None  # infinity; loop over r ends here
                    continue
                lam = 3 * tx * tx % P * pow(2 * ty % P, P - 2, P) % P
            else:
                lam = (py - ty) * pow((px - tx) % P, P - 2, P) % P
            f = f12_mul(f, _line_eval(tx, ty, lam, xq, yq))
            x3 = (lam * lam - tx - px) % P
            ty = (lam * (tx - x3) - ty) % P
            tx = x3
    return f


def pairing(p: G1, q) -> tuple:
    """Reduced Tate pairing e(P, Q) -> Fp12 element of order dividing r.

    P: bn254.G1 (Jacobian or affine); Q: twist point ((x0,x1),(y0,y1)) or
    None.  e(inf, Q) = e(P, inf) = 1.
    """
    p_aff = p.to_affine() if isinstance(p, G1) else p
    if p_aff is None or q is None:
        return F12_ONE
    assert g2_is_on_curve(q), "Q not on the twist"
    f = miller_loop(p_aff, _psi(q))
    return f12_pow(f, FINAL_EXP)


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 (the Groth16 verification shape).

    Miller loops are combined before one shared final exponentiation.
    """
    f = F12_ONE
    for p, q in pairs:
        p_aff = p.to_affine() if isinstance(p, G1) else p
        if p_aff is None or q is None:
            continue
        assert g2_is_on_curve(q), "Q not on the twist"
        f = f12_mul(f, miller_loop(p_aff, _psi(q)))
    return f12_eq(f12_pow(f, FINAL_EXP), F12_ONE)
