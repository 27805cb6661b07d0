"""Sparse R1CS builder + in-circuit gadget library for the Groth16 wrap.

The wrap circuit (groth16/circuit.py) verifies the identity_p254
final-shrink STARK (recursion/identity.py): BN254-native Poseidon for
every hash/transcript step, Baby Bear arithmetic emulated in the BN254
scalar field with lazy-reduction bounds. Counterpart of
`boundless_tpu/groth16/r1cs.py`, copied. It provides:

  * `Builder` — sparse R1CS over Fr with simultaneous witness
    evaluation (run it with concrete values to generate the witness;
    run it with `None` values to lay out the identical circuit for CRS
    setup — all control flow is static).
  * `BB` — a Baby Bear element as an Fr linear combination with a
    magnitude bound: adds/constant-muls stay linear (bound-tracked),
    `bb_mul` emits one product constraint plus a normalization
    (quotient/remainder bit decomposition), matching the classic
    nonnative-arithmetic recipe (reference role: the circom BN254
    circuit behind `blake3_groth16`, SURVEY.md §2.4).
  * native Poseidon-BN254 permutation (3 constraints per x^5 S-box,
    linear layers free — core/poseidon_bn254.py constants).

Conventions: variable 0 is the constant 1; public variables are
allocated first (`pub_var`). LCs are {var: coef} dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .bn254 import R as FR
from ..core import poseidon_bn254 as P254

BB_P = 2013265921  # Baby Bear modulus
BB_BITS = 31
# normalize lazily before a product would overflow Fr (~2^253); keep a
# generous margin so linear pile-ups never need per-op checks
MAX_BOUND = 1 << 120

LC = Dict[int, int]


def _lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % FR
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def _lc_scale(a: LC, c: int) -> LC:
    c %= FR
    if not c:
        return {}
    return {k: (v * c) % FR for k, v in a.items()}


class Builder:
    """Sparse R1CS with optional concrete evaluation.

    `values[i]` is the concrete Fr value of variable i, or None in
    layout mode. Gadgets must branch only on static data.
    """

    def __init__(self, concrete: bool = True):
        self.concrete = concrete
        self.values: List[Optional[int]] = [1]
        self.n_pub = 0
        self.rows: List[Tuple[LC, LC, LC]] = []
        self._pub_frozen = False

    # -- variables ------------------------------------------------------
    def var(self, value: Optional[int]) -> int:
        i = len(self.values)
        self.values.append(value % FR if (self.concrete and value is not None)
                           else (None if not self.concrete else value))
        return i

    def pub_var(self, value: Optional[int]) -> int:
        assert not self._pub_frozen, "public vars must be allocated first"
        assert len(self.values) == 1 + self.n_pub
        self.n_pub += 1
        return self.var(value)

    def freeze_pub(self):
        self._pub_frozen = True

    def wit(self, value: Optional[int]) -> int:
        self._pub_frozen = True
        return self.var(value)

    # -- evaluation -----------------------------------------------------
    def val(self, lc: LC) -> Optional[int]:
        if not self.concrete:
            return None
        acc = 0
        for k, c in lc.items():
            v = self.values[k]
            assert v is not None
            acc = (acc + c * v) % FR
        return acc

    def lc(self, var: int, coef: int = 1) -> LC:
        return {var: coef % FR}

    def const_lc(self, c: int) -> LC:
        return {0: c % FR} if c % FR else {}

    # -- constraints ----------------------------------------------------
    def enforce(self, a: LC, b: LC, c: LC):
        if self.concrete:
            av, bv, cv = self.val(a), self.val(b), self.val(c)
            assert av * bv % FR == cv, "R1CS constraint violated"
        self.rows.append((a, b, c))

    def enforce_zero(self, a: LC):
        self.enforce(a, self.const_lc(1), {})

    def mul(self, a: LC, b: LC) -> LC:
        """Product wire: z = a * b."""
        av, bv = self.val(a), self.val(b)
        z = self.wit(None if av is None else av * bv % FR)
        self.enforce(a, b, self.lc(z))
        return self.lc(z)

    def bit(self, value: Optional[int]) -> LC:
        """Boolean witness: b * (b - 1) = 0."""
        b = self.wit(value)
        self.enforce(self.lc(b), _lc_add(self.lc(b), self.const_lc(FR - 1)),
                     {})
        return self.lc(b)

    def bits_of(self, lc: LC, nbits: int,
                value: Optional[int] = None) -> List[LC]:
        """Decompose lc into nbits bits (low first); enforces recompose."""
        v = self.val(lc) if value is None else value
        bits = [self.bit(None if v is None else (v >> i) & 1)
                for i in range(nbits)]
        acc: LC = {}
        for i, b in enumerate(bits):
            acc = _lc_add(acc, _lc_scale(b, 1 << i))
        self.enforce_zero(_lc_add(acc, _lc_scale(lc, FR - 1)))
        return bits

    # -- R1CS export ----------------------------------------------------
    def to_sparse(self) -> "SparseR1CS":
        return SparseR1CS(n_vars=len(self.values), n_pub=self.n_pub,
                          rows=self.rows)

    def witness(self) -> List[int]:
        assert self.concrete
        out = []
        for v in self.values:
            assert v is not None
            out.append(v)
        return out


@dataclasses.dataclass
class SparseR1CS:
    n_vars: int
    n_pub: int
    rows: List[Tuple[LC, LC, LC]]

    def is_satisfied(self, s: Sequence[int]) -> bool:
        def ev(lc):
            return sum(c * s[k] for k, c in lc.items()) % FR

        return all(ev(a) * ev(b) % FR == ev(c) for a, b, c in self.rows)


# ---------------------------------------------------------------------------
# Baby Bear nonnative arithmetic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BB:
    """A Baby Bear value as (lc, bound): the Fr value of `lc` is a
    nonnegative integer < bound that REPRESENTS its residue mod BB_P.
    Canonical values have bound == BB_P."""

    lc: LC
    bound: int

    @property
    def canonical(self) -> bool:
        return self.bound <= BB_P


class BBOps:
    """Gadget set over BB values, bound-tracked with lazy reduction."""

    def __init__(self, bld: Builder):
        self.b = bld

    def const(self, c: int) -> BB:
        c %= BB_P
        return BB(self.b.const_lc(c), c + 1 if c else 1)

    def add(self, x: BB, y: BB) -> BB:
        z = BB(_lc_add(x.lc, y.lc), x.bound + y.bound)
        if z.bound > MAX_BOUND:
            z = self.norm(z)
        return z

    def scale(self, x: BB, c: int) -> BB:
        c %= BB_P
        z = BB(_lc_scale(x.lc, c), x.bound * max(c, 1))
        if z.bound > MAX_BOUND:
            z = self.norm(z)
        return z

    def sub(self, x: BB, y: BB) -> BB:
        """x - y via adding a multiple of BB_P to keep values nonneg."""
        k = -(-y.bound // BB_P)  # ceil
        lifted = _lc_add(x.lc, self.b.const_lc(k * BB_P))
        z = BB(_lc_add(lifted, _lc_scale(y.lc, FR - 1)),
               x.bound + k * BB_P)
        if z.bound > MAX_BOUND:
            z = self.norm(z)
        return z

    def norm(self, x: BB) -> BB:
        """Reduce to canonical: x = q*BB_P + r with r < BB_P."""
        if x.canonical:
            return x
        v = self.b.val(x.lc)
        qbits = max((x.bound // BB_P).bit_length(), 1)
        if v is None:
            q_lc_bits = [self.b.bit(None) for _ in range(qbits)]
            r = self._canonical_wit(None)
        else:
            q_lc_bits = [self.b.bit((v // BB_P >> i) & 1)
                         for i in range(qbits)]
            r = self._canonical_wit(v % BB_P)
        q: LC = {}
        for i, bb in enumerate(q_lc_bits):
            q = _lc_add(q, _lc_scale(bb, 1 << i))
        # x == q*P + r
        self.b.enforce_zero(_lc_add(
            x.lc, _lc_scale(_lc_add(_lc_scale(q, BB_P), r.lc), FR - 1)))
        return r

    def _canonical_wit(self, value: Optional[int]) -> BB:
        """Fresh canonical BB witness: 31 bits + the < P check.

        BB_P - 1 = 15*2^27: a 31-bit value is < P iff NOT (top4 == 15
        and low27 > 0); equivalently top4==15 forces low27 == 0
        (equality to P-1 allowed)."""
        bits = [self.b.bit(None if value is None else (value >> i) & 1)
                for i in range(BB_BITS)]
        lc: LC = {}
        for i, bb in enumerate(bits):
            lc = _lc_add(lc, _lc_scale(bb, 1 << i))
        t = self.b.mul(bits[27], bits[28])
        t = self.b.mul(t, bits[29])
        t = self.b.mul(t, bits[30])
        low: LC = {}
        for i in range(27):
            low = _lc_add(low, _lc_scale(bits[i], 1 << i))
        self.b.enforce(t, low, {})
        return BB(lc, BB_P)

    def wit_canonical(self, value: Optional[int]) -> BB:
        """Witness a fresh canonical BB element (opened rows, taps...)."""
        return self._canonical_wit(value)

    def mul(self, x: BB, y: BB) -> BB:
        x = self.norm(x)
        y = self.norm(y)
        z_lc = self.b.mul(x.lc, y.lc)
        return self.norm(BB(z_lc, BB_P * BB_P))

    def assert_eq(self, x: BB, y: BB):
        d = self.sub(x, y)
        d = self.norm(d)
        # canonical difference must be exactly zero
        self.b.enforce_zero(d.lc)

    def assert_zero(self, x: BB):
        d = self.norm(x)
        self.b.enforce_zero(d.lc)

    def inv(self, x: BB) -> BB:
        """Multiplicative inverse witness (x must be nonzero)."""
        x = self.norm(x)
        v = self.b.val(x.lc)
        iv = None if v is None else pow(v % BB_P, BB_P - 2, BB_P)
        y = self._canonical_wit(iv)
        prod = self.mul(x, y)
        self.assert_eq(prod, self.const(1))
        return y

    # -- quartic extension (x^4 - 11) -----------------------------------

    def ext_const(self, vec) -> List[BB]:
        return [self.const(int(v)) for v in vec]

    def ext_add(self, a, b):
        return [self.add(x, y) for x, y in zip(a, b)]

    def ext_sub(self, a, b):
        return [self.sub(x, y) for x, y in zip(a, b)]

    def ext_scale_bb(self, a, s: BB):
        return [self.mul(x, s) for x in a]

    def ext_mul(self, a, b):
        m = self.mul
        add, sc = self.add, lambda x: self.scale(x, 11)
        c0 = add(m(a[0], b[0]),
                 sc(add(add(m(a[1], b[3]), m(a[2], b[2])), m(a[3], b[1]))))
        c1 = add(add(m(a[0], b[1]), m(a[1], b[0])),
                 sc(add(m(a[2], b[3]), m(a[3], b[2]))))
        c2 = add(add(m(a[0], b[2]), add(m(a[1], b[1]), m(a[2], b[0]))),
                 sc(m(a[3], b[3])))
        c3 = add(add(m(a[0], b[3]), m(a[1], b[2])),
                 add(m(a[2], b[1]), m(a[3], b[0])))
        return [c0, c1, c2, c3]

    def ext_assert_eq(self, a, b):
        for x, y in zip(a, b):
            self.assert_eq(x, y)

    def ext_inv(self, a) -> List[BB]:
        """Witness the inverse ext element; enforce a * inv == 1."""
        vals = [self.b.val(self.norm(x).lc) for x in a]
        if any(v is None for v in vals):
            inv_vals = [None] * 4
        else:
            # host inverse via the extension-norm method
            a0, a1, a2, a3 = [v % BB_P for v in vals]
            abar = (a0, (-a1) % BB_P, a2, (-a3) % BB_P)
            n1 = _py_ext_mul((a0, a1, a2, a3), abar)
            e0, e2 = n1[0], n1[2]
            norm = (e0 * e0 - 11 * e2 * e2) % BB_P
            ninv = pow(norm, BB_P - 2, BB_P)
            n1c = (e0, 0, (-e2) % BB_P, 0)
            # multiply abar * (e0 - e2 x^2) * ninv
            t = _py_ext_mul(abar, n1c)
            inv_vals = [v * ninv % BB_P for v in t]
        inv = [self._canonical_wit(v) for v in inv_vals]
        prod = self.ext_mul(a, inv)
        self.ext_assert_eq(prod, self.ext_const([1, 0, 0, 0]))
        return inv


# ---------------------------------------------------------------------------
# Native Poseidon-BN254 gadget
# ---------------------------------------------------------------------------


def poseidon_perm(bld: Builder, state: List[LC]) -> List[LC]:
    """In-circuit Poseidon-BN254 permutation on 3 felt LCs (native field:
    3 constraints per x^5 S-box, linear layers free)."""
    rcs, mds = P254.constants()
    s = list(state)
    half = P254.ROUNDS_FULL // 2
    nrounds = P254.ROUNDS_FULL + P254.ROUNDS_PARTIAL

    def sbox(lc: LC) -> LC:
        x2 = bld.mul(lc, lc)
        x4 = bld.mul(x2, x2)
        return bld.mul(x4, lc)

    for r in range(nrounds):
        s = [_lc_add(s[i], bld.const_lc(rcs[r][i])) for i in range(3)]
        if half <= r < half + P254.ROUNDS_PARTIAL:
            s[0] = sbox(s[0])
        else:
            s = [sbox(x) for x in s]
        s = [_lc_add(_lc_add(_lc_scale(s[0], mds[i][0]),
                             _lc_scale(s[1], mds[i][1])),
                     _lc_scale(s[2], mds[i][2])) for i in range(3)]
    return s


def poseidon_hash_felts(bld: Builder, felts: List[LC]) -> LC:
    """In-circuit mirror of poseidon_bn254.hash_felts (rate-2 sponge)."""
    fs = list(felts) or [bld.const_lc(0)]
    if len(fs) % 2:
        fs.append(bld.const_lc(0))
    s = [bld.const_lc(0)] * 3
    for i in range(0, len(fs), 2):
        s = [_lc_add(s[0], fs[i]), _lc_add(s[1], fs[i + 1]), s[2]]
        s = poseidon_perm(bld, s)
    return s[0]


def poseidon_hash_pair(bld: Builder, a: LC, b: LC) -> LC:
    return poseidon_perm(bld, [a, b, bld.const_lc(0)])[0]


def pack_bb_felts(bld: Builder, ops: BBOps, elems: List[BB]) -> List[LC]:
    """Canonical BB wires -> felt LCs (8 per felt; pure linear — the
    canonicity of each element makes the packing injective)."""
    for e in elems:
        assert e.canonical, "pack requires canonical BB elements"
    out = []
    for i in range(0, max(len(elems), 1), P254.PACK):
        acc: LC = {}
        for j, e in enumerate(elems[i : i + P254.PACK]):
            acc = _lc_add(acc, _lc_scale(e.lc, 1 << (31 * j)))
        out.append(acc)
    return out


def _py_ext_mul(a, b):
    """Quartic-extension multiply (X^4 = 11) on canonical Python-int
    4-tuples (the reference's `core/field.py_ext_mul`)."""
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + a[i] * b[j]) % BB_P
    for k in range(6, 3, -1):
        c[k - 4] = (c[k - 4] + 11 * c[k]) % BB_P
    return tuple(c[:4])
