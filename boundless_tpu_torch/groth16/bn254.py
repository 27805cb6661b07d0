"""BN254 (alt_bn128) base/scalar fields and G1 arithmetic.

Counterpart of `boundless_tpu/groth16/bn254.py`, copied: the host-exact
curve (Python ints) under the STARK->SNARK wrap (reference
`blake3_groth16/` + `risc0-groth16-sys` CUDA MSM). The card's MSM
(`kernels/msm.py`, `csrc/msm.cu`) is held to it.
"""

from __future__ import annotations

import dataclasses

# Curve: y^2 = x^3 + 3 over F_p; r = scalar field order.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
G1_GEN = (1, 2)


@dataclasses.dataclass(frozen=True)
class G1:
    """Jacobian point (X, Y, Z); Z=0 is infinity."""

    x: int
    y: int
    z: int = 1

    @staticmethod
    def infinity() -> "G1":
        return G1(1, 1, 0)

    @staticmethod
    def generator() -> "G1":
        return G1(*G1_GEN)

    def is_infinity(self) -> bool:
        return self.z == 0

    def to_affine(self):
        if self.z == 0:
            return None
        zi = pow(self.z, P - 2, P)
        zi2 = zi * zi % P
        return (self.x * zi2 % P, self.y * zi2 * zi % P)

    @staticmethod
    def from_affine(xy) -> "G1":
        if xy is None:
            return G1.infinity()
        x, y = xy
        assert (y * y - x * x * x - B) % P == 0, "point not on curve"
        return G1(x % P, y % P, 1)

    def double(self) -> "G1":
        if self.z == 0 or self.y == 0:
            return G1.infinity() if self.y == 0 else self
        X, Y, Z = self.x, self.y, self.z
        A = X * X % P
        Bv = Y * Y % P
        C = Bv * Bv % P
        D = 2 * ((X + Bv) * (X + Bv) - A - C) % P
        E = 3 * A % P
        Fv = E * E % P
        X3 = (Fv - 2 * D) % P
        Y3 = (E * (D - X3) - 8 * C) % P
        Z3 = 2 * Y * Z % P
        return G1(X3, Y3, Z3)

    def add(self, other: "G1") -> "G1":
        if self.z == 0:
            return other
        if other.z == 0:
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = other.x, other.y, other.z
        Z1Z1 = Z1 * Z1 % P
        Z2Z2 = Z2 * Z2 % P
        U1 = X1 * Z2Z2 % P
        U2 = X2 * Z1Z1 % P
        S1 = Y1 * Z2 * Z2Z2 % P
        S2 = Y2 * Z1 * Z1Z1 % P
        if U1 == U2:
            if S1 != S2:
                return G1.infinity()
            return self.double()
        H = (U2 - U1) % P
        I = 4 * H * H % P
        J = H * I % P
        r = 2 * (S2 - S1) % P
        V = U1 * I % P
        X3 = (r * r - J - 2 * V) % P
        Y3 = (r * (V - X3) - 2 * S1 * J) % P
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
        return G1(X3, Y3, Z3)

    def neg(self) -> "G1":
        return G1(self.x, (-self.y) % P, self.z)

    def mul(self, k: int) -> "G1":
        k %= R
        acc = G1.infinity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc

    def eq(self, other: "G1") -> bool:
        a, b = self.to_affine(), other.to_affine()
        return a == b
