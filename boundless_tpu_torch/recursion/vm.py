"""Recursion VM: straight-line wire programs for the recursion circuit.

Counterpart of `boundless_tpu/recursion/vm.py`: the same op encoding,
program construction and ROM, so a program built here has the JAX package's ROM word
for word. The data trace comes from the C++ evaluator
(`native/rec_eval.cpp`, `evaluate_native`; `NATIVE_EVALS` counts its
runs); the Python `evaluate` is its plain version.

Replacement for the reference's recursion circuit prover
(`risc0-circuit-recursion-sys`, SURVEY.md §2.4; task call-sites
`prover/crates/workflow/src/tasks/{prove,join,union,resolve}.rs`). The
reference runs "recursion VM programs" (lift/join/union/resolve/
identity_p254) on a dedicated circuit; here the analogue is:

  * a **program** is a straight-line list of ops over write-once wires
    (this module: `Prog` + exact host evaluator). No control
    flow — the STARK verifier we need to express is static-shape, so
    every loop unrolls at build time (the same property that makes it
    XLA-friendly makes it ROM-friendly).
  * each op is one row of the recursion AIR (`recursion/air.py`); the
    ROM (opcode/addresses/immediates) is the circuit's **ctrl group**,
    so a program's identity is its ctrl Merkle root ("control ID" —
    the reference's control-root lattice, `risc0_zkvm` control ids).
  * wires are quartic-extension elements (4 base columns); reads go
    through a LogUp write-once-memory argument; Poseidon2 runs as
    dedicated wide rows over 24 state columns (one row per round).

Op set (ROM `sel` one-hot):
  GEN    out = cmul*(in1 x in2) + sum_c pmulw[c]*in1[c]*in2
             + ca*in1 + cb*in2 + cc*in3 + imm          (ext algebra)
  INPUT  out = free witness (the proof stream)
  BIT    out = (b, 0, 0, 0), b boolean (witness; linked by program
         asserts, the ROM hint fields are evaluator-only)
  PUB    out[c] = pub[4g + c] (public values of the recursion proof)
  INV    in1 x out == 1  (proves in1 != 0)
  AZ     in1 == 0 and out == 0
  PPRE   st' = M_E st                      (Poseidon2 initial linear)
  PEXT   st' = M_E sbox(st + rc)           (full round; rc in ROM)
  PINT   st' = M_I (sbox(st0+rc0), st1..)  (partial round)
  PABS   st'[j] = st[j] + K[j]*in1[j mod 4] (absorb 4 lanes by mask)
  PZERO  st' = 0
  POUT   out[c] = sum_{j: K[j]=1, j mod 4 = c} st[j]; st' = st

Rows not in {PPRE,PEXT,PINT,PABS,PZERO} carry st forward unchanged, so
a duplex-sponge transcript persists across interleaved arithmetic.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..air.dsl import Alloc
from ..core import field as F
from ..core import poseidon2 as P2
from ..core.poseidon2_np import M4

P = F.P

# Opcode indices (ROM sel one-hot).
OPS = ("gen", "input", "bit", "pub", "inv", "az",
       "ppre", "pext", "pint", "pabs", "pzero", "pout")
NOPS = len(OPS)
OP = {name: i for i, name in enumerate(OPS)}

KW = 24  # width of the multi-purpose K block (= Poseidon2 width)
NPUB_GROUPS = 6  # pub vector: 6 groups x 4 scalars
PUB_VALS = 4 * NPUB_GROUPS

# GEN-op K-layout
K_IMM = 0      # [0:4] immediate (ext, canonical here; Montgomery in trace)
K_CMUL = 4
K_CA = 5
K_CB = 6
K_CC = 7
K_PMULW = 8    # [8:12] effective pick-component weights


class CtrlCols:
    """ROM layout (the circuit's ctrl group)."""

    def __init__(self):
        a = Alloc()
        self.sel = a.get(NOPS)
        self.is_first = a.get()
        self.not_last = a.get()
        self.rowidx = a.get()
        self.mcount = a.get()  # WOM read multiplicity (program-static)
        self.a1 = a.get()
        self.a2 = a.get()
        self.a3 = a.get()
        self.en1 = a.get()
        self.en2 = a.get()
        self.en3 = a.get()
        self.K = a.get(KW)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


class DataCols:
    """Per-row data group layout."""

    def __init__(self):
        a = Alloc()
        self.in1 = a.get(4)
        self.in2 = a.get(4)
        self.in3 = a.get(4)
        self.out = a.get(4)
        self.st = a.get(24)
        self.x3 = a.get(24)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


class AccumCols:
    def __init__(self):
        a = Alloc()
        self.inw = a.get(4)
        self.inr = [a.get(4) for _ in range(3)]
        self.running = a.get(4)
        self.pad = a.get((-a.n) % 8)
        self.total = a.n


CC = CtrlCols()
DC = DataCols()
AC = AccumCols()


# ---------------------------------------------------------------------------
# Canonical-int field helpers (exact host math, mirrors core/field.py)
# ---------------------------------------------------------------------------


def _ext_mul(a, b):
    """Quartic multiply on canonical int 4-tuples (x^4 = BETA)."""
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + a[i] * b[j]) % P
    for k in range(6, 3, -1):
        c[k - 4] = (c[k - 4] + F.BETA * c[k]) % P
    return tuple(c[:4])


def _ext_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def _ext_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def _ext_scale(a, s):
    return tuple(x * s % P for x in a)


def py_ext_inv(a) -> tuple:
    """Canonical quartic inverse (norm map; inv(0) = 0)."""
    abar = (a[0], (-a[1]) % P, a[2], (-a[3]) % P)
    n1 = _ext_mul(a, abar)
    e0, e2 = n1[0], n1[2]
    norm = (e0 * e0 - F.BETA * e2 * e2) % P
    if norm == 0:
        return (0, 0, 0, 0)
    ninv = pow(norm, P - 2, P)
    n1c = (e0, 0, (-e2) % P, 0)
    out = _ext_mul(abar, n1c)
    return tuple(x * ninv % P for x in out)


# Canonical (non-Montgomery) Poseidon2 constants of core/poseidon2.py.
_EXT_RC, _INT_RC, _MU = P2.canonical_constants()

# Full 24x24 external matrix (M_E = circ(2*M4, M4, ..., M4)) and internal
# matrix (M_I = J + diag(mu)), canonical int64.
def _full_matrices():
    me = np.zeros((24, 24), dtype=np.int64)
    for bi in range(6):
        for bj in range(6):
            blk = M4 * (2 if bi == bj else 1)
            me[4 * bi : 4 * bi + 4, 4 * bj : 4 * bj + 4] = blk
    mi = np.ones((24, 24), dtype=np.int64)
    mi[np.arange(24), np.arange(24)] += _MU
    mi %= P
    return me, mi


M_EXT, M_INT = _full_matrices()


def _sbox7(x: int) -> int:
    x3 = x * x % P * x % P
    return x3 * x3 % P * x % P


def perm_canonical(state: Sequence[int]) -> list:
    """Poseidon2 permutation on canonical ints (parity: core.poseidon2)."""
    st = list(state)

    def ext_linear(s):
        return [int(sum(int(M_EXT[j, k]) * s[k] for k in range(24)) % P)
                for j in range(24)]

    st = ext_linear(st)
    half = P2.ROUNDS_FULL // 2
    for r in range(half):
        st = ext_linear([_sbox7((st[j] + int(_EXT_RC[r, j])) % P)
                         for j in range(24)])
    for r in range(P2.ROUNDS_PARTIAL):
        v = [_sbox7((st[0] + int(_INT_RC[r])) % P)] + st[1:]
        tot = sum(v) % P
        st = [(tot + int(_MU[j]) * v[j]) % P for j in range(24)]
    for r in range(half, P2.ROUNDS_FULL):
        st = ext_linear([_sbox7((st[j] + int(_EXT_RC[r, j])) % P)
                         for j in range(24)])
    return st


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Row:
    op: int
    a: Tuple[int, int, int] = (0, 0, 0)
    en: Tuple[int, int, int] = (0, 0, 0)
    K: Optional[np.ndarray] = None  # canonical int64 (KW,)
    # evaluator-only hints (not part of the committed ROM / soundness):
    hint: tuple = ()


class Prog:
    """A straight-line program. Wire == row index of the producer."""

    def __init__(self, name: str = "prog"):
        self.name = name
        self.rows: List[Row] = []
        self.n_inputs = 0
        self._one: Optional[int] = None
        self._basis_cache: dict = {}
        # shadow transcript pool for duplex squeeze scheduling
        self._pool = P2.RATE

    # --- core row emitters -------------------------------------------------

    def _emit(self, op: str, a=(0, 0, 0), en=(0, 0, 0), K=None,
              hint=()) -> int:
        self.rows.append(Row(OP[op], tuple(a), tuple(en),
                             None if K is None else np.asarray(
                                 K, dtype=np.int64) % P, hint))
        return len(self.rows) - 1

    def gen(self, a1=0, a2=0, a3=0, *, imm=(0, 0, 0, 0), cmul=0, ca=0,
            cb=0, cc=0, pmulw=(0, 0, 0, 0)) -> int:
        K = np.zeros(KW, dtype=np.int64)
        K[K_IMM : K_IMM + 4] = [x % P for x in imm]
        K[K_CMUL] = cmul % P
        K[K_CA] = ca % P
        K[K_CB] = cb % P
        K[K_CC] = cc % P
        K[K_PMULW : K_PMULW + 4] = [x % P for x in pmulw]
        en = (1 if (ca or cmul or any(pmulw)) and a1 is not None else 0,
              1 if (cb or cmul or any(pmulw)) else 0,
              1 if cc else 0)
        return self._emit("gen", (a1 or 0, a2 or 0, a3 or 0), en, K)

    # --- public program API ------------------------------------------------

    def const(self, val) -> int:
        if isinstance(val, int):
            val = (val, 0, 0, 0)
        return self.gen(imm=tuple(int(v) % P for v in val))

    def one(self) -> int:
        if self._one is None:
            self._one = self.const(1)
        return self._one

    def input(self) -> int:
        self.n_inputs += 1
        return self._emit("input", hint=("in", self.n_inputs - 1))

    def bit(self, src: int, comp: int, idx: int) -> int:
        """Boolean witness wire; hinted as bit `idx` of canonical value of
        component `comp` of wire `src` (soundness comes from the caller's
        recomposition asserts, not the hint)."""
        return self._emit("bit", (src, 0, 0), hint=("bit", src, comp, idx))

    def flag_eqz(self, src: int, comp: int = 0) -> int:
        """Boolean witness wire hinted as (wire[src][comp] == 0).

        Only the booleanness is constrained by the BIT row; callers must
        add the semantic asserts (e.g. b * x == 0 plus a covering-sum
        constraint for the b == 0 direction)."""
        return self._emit("bit", (src, 0, 0), hint=("eqz", src, comp))

    def input_bit(self) -> int:
        """Witness input constrained to {0, 1} (x*x == x; the quartic
        extension is a field, so 0/1 are its only idempotents)."""
        w = self.input()
        self.assert_zero(self.sub(self.mul(w, w), w))
        return w

    def pub(self, group: int) -> int:
        assert 0 <= group < NPUB_GROUPS
        K = np.zeros(KW, dtype=np.int64)
        K[group] = 1
        return self._emit("pub", K=K, hint=("pub", group))

    def add(self, x: int, y: int) -> int:
        return self.gen(x, y, ca=1, cb=1)

    def sub(self, x: int, y: int) -> int:
        return self.gen(x, y, ca=1, cb=P - 1)

    def mul(self, x: int, y: int) -> int:
        return self.gen(x, y, cmul=1)

    def muladd(self, x: int, y: int, z: int) -> int:
        """x*y + z."""
        return self.gen(x, y, z, cmul=1, cc=1)

    def _mul_basis(self, x: int, c: int, kc: int) -> int:
        """x * (kc * X^c) for the extension basis X^c (emitted as a GEN
        with a constant multiplicand wire; the constant wire is cached)."""
        key = (c, kc % P)
        w = self._basis_cache.get(key)
        if w is None:
            w = self.const(tuple(kc % P if i == c else 0 for i in range(4)))
            self._basis_cache[key] = w
        return self.mul(x, w)

    def addc(self, x: int, imm) -> int:
        if isinstance(imm, int):
            imm = (imm, 0, 0, 0)
        return self.gen(x, ca=1, imm=imm)

    def pick(self, x: int, comp: int) -> int:
        """Base scalar = component `comp` of x (as a base-only wire)."""
        w = np.zeros(4, dtype=np.int64)
        w[comp] = 1
        return self.gen(x, self.one(), pmulw=tuple(w))

    def pickmul(self, x: int, comp: int, y: int, z: Optional[int] = None
                ) -> int:
        """x[comp] * y (+ z)."""
        w = np.zeros(4, dtype=np.int64)
        w[comp] = 1
        if z is None:
            return self.gen(x, y, pmulw=tuple(w))
        return self.gen(x, y, z, pmulw=tuple(w), cc=1)

    def select(self, b: int, x: int, y: int) -> int:
        """b ? x : y  (b a bit wire)."""
        t = self.sub(x, y)
        return self.muladd(b, t, y)

    def inv(self, x: int) -> int:
        return self._emit("inv", (x, 0, 0), (1, 0, 0))

    def assert_zero(self, x: int) -> int:
        return self._emit("az", (x, 0, 0), (1, 0, 0))

    def assert_eq(self, x: int, y: int):
        self.assert_zero(self.sub(x, y))

    # --- Poseidon2 macros --------------------------------------------------

    def p_zero(self):
        self._emit("pzero")

    def p_absorb(self, wire: int, slot: int):
        """st[4*slot : 4*slot+4] += wire components."""
        K = np.zeros(KW, dtype=np.int64)
        K[4 * slot : 4 * slot + 4] = 1
        self._emit("pabs", (wire, 0, 0), (1, 0, 0), K)

    def p_rounds(self):
        """The full permutation round sequence (after any absorbs)."""
        self._emit("ppre")
        half = P2.ROUNDS_FULL // 2
        for r in range(half):
            self._emit("pext", K=_EXT_RC[r])
        for r in range(P2.ROUNDS_PARTIAL):
            K = np.zeros(KW, dtype=np.int64)
            K[0] = _INT_RC[r]
            self._emit("pint", K=K)
        for r in range(half, P2.ROUNDS_FULL):
            self._emit("pext", K=_EXT_RC[r])

    def p_out(self, quad: int) -> int:
        """Wire = st[4*quad : 4*quad+4] (state preserved)."""
        K = np.zeros(KW, dtype=np.int64)
        K[4 * quad : 4 * quad + 4] = 1
        return self._emit("pout", K=K)

    # --- transcript / hashing macros (mirror core/transcript.py) -----------

    def t_init(self):
        """Zero the sponge state (start of a transcript)."""
        self.p_zero()
        self._pool = P2.RATE

    def t_mix_digest(self, digest2: Tuple[int, int]):
        """Absorb an 8-word digest given as two packed wires."""
        self.p_absorb(digest2[0], 0)
        self.p_absorb(digest2[1], 1)
        self.p_rounds()
        self._pool = 0

    def t_sample_ext(self) -> int:
        if self._pool >= P2.RATE:
            self.p_rounds()
            self._pool = 0
        if self._pool % 4 == 0 and self._pool + 4 <= P2.RATE:
            w = self.p_out(self._pool // 4)
            self._pool += 4
            return w
        # unaligned: compose from 4 scalar squeezes (matches
        # transcript.sample_ext = stack of 4 consecutive sample_elem,
        # including a mid-ext re-permute at the rate boundary)
        elems = [self.t_sample_elem() for _ in range(4)]
        acc = elems[0]
        for c in range(1, 4):
            acc = self.add(acc, self._mul_basis(elems[c], c, 1))
        return acc

    def t_sample_elem(self) -> int:
        """One base-field squeeze (mirrors transcript.sample_elem)."""
        if self._pool >= P2.RATE:
            self.p_rounds()
            self._pool = 0
        q, comp = divmod(self._pool, 4)
        w = self.p_out(q)
        self._pool += 1
        return self.pick(w, comp)

    def t_sample_u32_bits(self, nbits: int):
        """Index sample (mirrors transcript.sample_u32 & mask(nbits)).

        Two squeezes a, b -> idx = (a & 0xffff) | ((b & 0xffff) << 16),
        masked to nbits. Returns (bits low->high, value wire).
        """
        assert 1 <= nbits <= 32
        a = self.t_sample_elem()
        b = self.t_sample_elem()
        abits = self.decompose(a, 0, nbits=31)
        bbits = self.decompose(b, 0, nbits=31)
        bits = abits[: min(nbits, 16)] + bbits[: max(0, nbits - 16)]
        acc = None
        for i, bw in enumerate(bits):
            term = self.gen(bw, ca=pow(2, i, P))
            acc = term if acc is None else self.add(acc, term)
        return bits, acc

    def t_save_state(self) -> list:
        """Snapshot the 24-wide sponge state as 6 quad wires."""
        return [self.p_out(q) for q in range(6)]

    def t_restore_state(self, quads: Sequence[int]):
        """Restore a snapshot (p_zero + 6 absorbs; pool is untouched)."""
        assert len(quads) == 6
        self.p_zero()
        for q, w in enumerate(quads):
            self.p_absorb(w, q)

    def t_mix_elems(self, wires: Sequence[int], total_elems: int):
        """Absorb a flat element vector (mirrors transcript.mix_elems:
        digest = standalone sponge hash, then mix_digest). Saves and
        restores the in-flight transcript state around the inner hash."""
        saved = self.t_save_state()
        d0, d1 = self.hash_packed(wires, total_elems)
        self.t_restore_state(saved)
        self.t_mix_digest((d0, d1))

    def hash_packed(self, wires: Sequence[int], total_elems: int
                    ) -> Tuple[int, int]:
        """Sponge-hash `total_elems` base elements packed 4-per-wire
        (mirrors poseidon2.hash_elems: zero-padded final block).

        Stand-alone hash: uses the sponge state registers, so it must not
        be interleaved with an in-flight transcript absorb phase. Returns
        the digest as two packed wires. Caller's transcript pool is
        unaffected (use t_mix_digest to absorb the result).
        """
        assert total_elems <= 4 * len(wires) < total_elems + 4 or \
            total_elems == 4 * len(wires)
        self.p_zero()
        nblocks = max(1, -(-total_elems // P2.RATE))
        wi = 0
        for b in range(nblocks):
            for slot in range(P2.RATE // 4):
                if wi < len(wires):
                    self.p_absorb(wires[wi], slot)
                    wi += 1
            self.p_rounds()
        d0 = self.p_out(0)
        d1 = self.p_out(1)
        return d0, d1

    # --- decomposition -----------------------------------------------------

    def decompose(self, w: int, comp: int, nbits: int = 31) -> list:
        """Canonical bit decomposition of component `comp` of wire `w`.

        Returns bit wires b0..b{nbits-1}. Asserts the recomposition equals
        the component and (for nbits=31) that the value is canonical
        (< P = 15*2^27 + 1): top4 == 15 forces low 27 bits zero.
        """
        bits = [self.bit(w, comp, i) for i in range(nbits)]
        acc = None
        low27 = None
        for i, b in enumerate(bits):
            term = self.gen(b, ca=pow(2, i, P))
            acc = term if acc is None else self.add(acc, term)
            if i == 26:
                low27 = acc
        self.assert_eq(acc, self.pick(w, comp))
        if nbits == 31:
            f = self.mul(bits[27], bits[28])
            f = self.mul(f, bits[29])
            f = self.mul(f, bits[30])
            self.assert_zero(self.mul(f, low27))
        return bits

    # --- ROM emission ------------------------------------------------------

    def finalize(self, n: int) -> "Prog":
        """Pad with inert INPUT rows to n rows. Returns self.

        Strict: at least one pad row is required, so the last row never
        carries a Poseidon state transition (air.py's st-update
        constraints rely on this to skip the `not_last` factor and stay
        within the degree-5 budget). Idempotent for the same n.
        """
        if len(self.rows) == n:
            assert self.rows[-1].hint == ("pad",), "finalize: no pad row"
            return self
        assert len(self.rows) < n, (len(self.rows), n)
        while len(self.rows) < n:
            self._emit("input", hint=("pad",))
        return self

    def ctrl_trace_np(self) -> np.ndarray:
        """The committed ROM: canonical int64 (N, CC.total)."""
        ops, addr, en, K, _, _ = _native_pack(self)
        n = len(ops)
        rows = np.arange(n)
        mcount = sum(np.bincount(addr[en[:, p] != 0, p], minlength=n)
                     for p in range(3))
        rom = np.zeros((n, CC.total), dtype=np.int64)
        rom[rows, CC.sel.start + ops] = 1
        rom[:, CC.rowidx] = rows
        rom[:, CC.mcount] = mcount
        rom[:, [CC.a1, CC.a2, CC.a3]] = addr
        rom[:, [CC.en1, CC.en2, CC.en3]] = en
        rom[:, CC.K] = K
        rom[0, CC.is_first] = 1
        rom[: n - 1, CC.not_last] = 1
        return rom


# ---------------------------------------------------------------------------
# Evaluator (exact host execution -> data trace)
# ---------------------------------------------------------------------------


class EvalError(Exception):
    pass


def _native_pack(prog: Prog):
    """Row arrays for the C++ evaluator (cached on the Prog per length,
    so the post-finalize pack is rebuilt once)."""
    cached = getattr(prog, "_npack", None)
    if cached is not None and cached[0] == len(prog.rows):
        return cached[1]
    n = len(prog.rows)
    ops = np.zeros(n, dtype=np.int32)
    addr = np.zeros((n, 3), dtype=np.int32)
    en = np.zeros((n, 3), dtype=np.int32)
    K = np.zeros((n, KW), dtype=np.int64)
    hkind = np.zeros(n, dtype=np.int32)
    harg = np.zeros((n, 3), dtype=np.int32)
    HK = {"in": 1, "pad": 2, "bit": 3, "eqz": 4}
    for r, row in enumerate(prog.rows):
        ops[r] = row.op
        addr[r] = row.a
        en[r] = row.en
        if row.K is not None:
            K[r] = row.K
        if row.hint:
            hkind[r] = HK.get(row.hint[0], 0)
            args = row.hint[1:4]
            harg[r, : len(args)] = [int(x) for x in args]
    pack = tuple(np.ascontiguousarray(a)
                 for a in (ops, addr, en, K, hkind, harg))
    prog._npack = (n, pack)
    return pack


NATIVE_EVALS = 0  # data traces computed by the C++ evaluator
_EVALS_LOCK = threading.Lock()  # cluster workers evaluate from threads


def evaluate_native(prog: Prog, inputs, pub_vals) -> np.ndarray:
    """The C++ evaluator (native/rec_eval.cpp): the data trace of
    `evaluate`, word for word. A failed build or load raises; there is no
    Python fallback."""
    import ctypes

    from .. import native

    global NATIVE_EVALS
    lib = native.rec_eval_lib()
    ops, addr, en, K, hkind, harg = _native_pack(prog)
    n = len(prog.rows)
    ins = np.ascontiguousarray(
        np.asarray([list(t) for t in inputs], dtype=np.int64).reshape(-1, 4)
        % P)
    pub = np.ascontiguousarray(
        (np.asarray(list(pub_vals) + [0] * (PUB_VALS - len(pub_vals)),
                    dtype=np.int64)) % P)
    m_ext = np.ascontiguousarray(M_EXT.astype(np.int64))
    mu = np.ascontiguousarray(_MU.astype(np.int64))
    data = np.zeros((n, DC.total), dtype=np.int64)
    err = ctypes.create_string_buffer(256)
    cp = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    rc = lib.bt_rec_eval(cp(ops), cp(addr), cp(en), cp(K), cp(hkind),
                         cp(harg), ctypes.c_int64(n), cp(ins),
                         ctypes.c_int64(ins.shape[0]), cp(pub), cp(m_ext),
                         cp(mu), cp(data), err, ctypes.c_int(256))
    if rc != 0:
        raise EvalError(err.value.decode() or "native evaluation failed")
    with _EVALS_LOCK:
        NATIVE_EVALS += 1
    return data


def evaluate(prog: Prog, inputs: Sequence[Tuple[int, int, int, int]],
             pub_vals: Sequence[int]) -> np.ndarray:
    """Execute the program; returns the canonical data trace (N, DC.total).

    inputs: ext 4-tuples consumed by INPUT rows in order.
    pub_vals: PUB_VALS canonical scalars.
    Raises EvalError if an assertion row fails (witness unprovable).
    """
    n = len(prog.rows)
    data = np.zeros((n, DC.total), dtype=np.int64)
    wires: List[Tuple[int, int, int, int]] = [(0, 0, 0, 0)] * n
    st = [0] * 24
    in_i = 0
    pub_vals = list(pub_vals) + [0] * (PUB_VALS - len(pub_vals))

    for r, row in enumerate(prog.rows):
        op = OPS[row.op]
        st_next = st
        rd = [(0, 0, 0, 0)] * 3
        for p in range(3):
            if row.en[p]:
                rd[p] = wires[row.a[p]]
        out = (0, 0, 0, 0)
        if op == "gen":
            K = row.K
            acc = tuple(int(K[K_IMM + c]) for c in range(4))
            if K[K_CMUL]:
                acc = _ext_add(acc, _ext_scale(_ext_mul(rd[0], rd[1]),
                                               int(K[K_CMUL])))
            pw = [int(K[K_PMULW + c]) for c in range(4)]
            if any(pw):
                s = sum(pw[c] * rd[0][c] for c in range(4)) % P
                acc = _ext_add(acc, _ext_scale(rd[1], s))
            if K[K_CA]:
                acc = _ext_add(acc, _ext_scale(rd[0], int(K[K_CA])))
            if K[K_CB]:
                acc = _ext_add(acc, _ext_scale(rd[1], int(K[K_CB])))
            if K[K_CC]:
                acc = _ext_add(acc, _ext_scale(rd[2], int(K[K_CC])))
            out = acc
        elif op == "input":
            if row.hint and row.hint[0] == "pad":
                out = (0, 0, 0, 0)
            else:
                if in_i >= len(inputs):
                    raise EvalError("input stream exhausted")
                out = tuple(int(x) % P for x in inputs[in_i])
                in_i += 1
        elif op == "bit":
            if row.hint[0] == "eqz":
                _, src, comp = row.hint
                out = (1 if wires[src][comp] == 0 else 0, 0, 0, 0)
            else:
                _, src, comp, idx = row.hint
                out = ((wires[src][comp] >> idx) & 1, 0, 0, 0)
        elif op == "pub":
            g = int(np.argmax(row.K[:NPUB_GROUPS]))
            out = tuple(pub_vals[4 * g + c] for c in range(4))
        elif op == "inv":
            out = py_ext_inv(rd[0])
            if _ext_mul(rd[0], out) != (1, 0, 0, 0):
                raise EvalError(f"row {r}: inverse of zero")
        elif op == "az":
            if rd[0] != (0, 0, 0, 0):
                raise EvalError(f"row {r}: assert_zero failed: {rd[0]}")
            out = (0, 0, 0, 0)
        elif op == "ppre":
            st_next = [int(sum(int(M_EXT[j, k]) * st[k]
                               for k in range(24)) % P) for j in range(24)]
        elif op == "pext":
            rc = row.K
            y = [(st[j] + int(rc[j])) % P for j in range(24)]
            x3 = [yy * yy % P * yy % P for yy in y]
            data[r, DC.x3] = x3
            sb = [x3[j] * x3[j] % P * y[j] % P for j in range(24)]
            st_next = [int(sum(int(M_EXT[j, k]) * sb[k]
                               for k in range(24)) % P) for j in range(24)]
        elif op == "pint":
            y0 = (st[0] + int(row.K[0])) % P
            x30 = y0 * y0 % P * y0 % P
            data[r, DC.x3.start] = x30
            v = [x30 * x30 % P * y0 % P] + st[1:]
            tot = sum(v) % P
            st_next = [(tot + int(_MU[j]) * v[j]) % P for j in range(24)]
        elif op == "pabs":
            st_next = list(st)
            for j in range(24):
                if row.K[j]:
                    st_next[j] = (st[j] + rd[0][j % 4]) % P
        elif op == "pzero":
            st_next = [0] * 24
        elif op == "pout":
            vals = [0, 0, 0, 0]
            for j in range(24):
                if row.K[j]:
                    vals[j % 4] = st[j]
            out = tuple(vals)
        else:  # pragma: no cover
            raise EvalError(f"unknown op {op}")

        wires[r] = tuple(int(x) % P for x in out)
        data[r, DC.out] = wires[r]
        data[r, DC.in1] = rd[0]
        data[r, DC.in2] = rd[1]
        data[r, DC.in3] = rd[2]
        data[r, DC.st] = st
        st = st_next

    if in_i != len(inputs):
        raise EvalError(f"unconsumed inputs: {len(inputs) - in_i}")
    return data
