"""keccak-f[1600] coprocessor AIR — the batch permutation circuit.

Counterpart of `boundless_tpu/air/keccak.py`: the same columns, the same
constraints in the same order (so the in-circuit verifier of
`recursion/coproc_succinct.py` emits the reference's ROM word for word),
over the port's algebras (`air/dsl.py`). Three translations:
`accum_trace`'s running sum is an exact int64 prefix sum in place of the
reference's associative scan (field addition is exact, so both give the
same words); the witness expands each round's lanes to bits with numpy in
place of the per-bit Python loop (the same array); and under the degree
algebra the public sum is the algebra's `s_pub_const`, as in
`air/rv32im.py`, so the prover's degree plan covers this AIR. The AIR
does not declare the generated constraint kernel (`fused_cons` is False,
as the reference gates its fused kernel to rv32im): its quotient takes
the degree-split eager route on every device.

The reference's keccak coprocessor circuit (`risc0-circuit-keccak-sys`,
SURVEY.md §2.4; proved by `ProverServer::prove_keccak` at
`prover/crates/workflow/src/tasks/keccak.rs:71-84`): one segment proves a
BATCH of independent keccak-f[1600] permutations, 24 rows per
permutation (one round per row), fully bit-decomposed:

  * `a` (1600 bool cols) — the state at the top of the round; lane
    (x, y) bit z lives at column 64*(5*y + x) + z.
  * `c1`/`c2` (320 + 320) — theta column-parity helpers:
    c1[x,z] = a[x,0,z] (+) a[x,1,z] (+) a[x,2,z] and
    C[x,z] = c2 = c1 (+) a[x,3,z] (+) a[x,4,z] (each an XOR3, deg 3).
  * `b` (1600) — the post-theta/rho/pi state:
    b[pi(x,y), rot z] = a[x,y,z] (+) C[x-1,z] (+) C[x+1,z-1] (deg 3).
  * round transition (chi + iota): a'[x,y,z] =
    b[x,y,z] (+) (1 - b[x+1,y,z]) * b[x+2,y,z] (+) RC — an XOR3 of
    degrees (1,2,ctrl), total 4; gated by not-perm-end: 5 (the budget).
  * `in_limbs`/`out_limbs` (100 + 100) — the permutation's input and
    output states as 16-bit limbs, carried constant across the
    permutation's 24 rows, bound to `a` bits at the first row and to
    the chi/iota output expression at the last.
  * a LogUp port family (5 ports/row) binds every limb pair to the
    PUBLIC state table: entry seq = 100*perm + slot, value =
    (limb[2*slot], limb[2*slot+1]), so the verifier (and the keccak-lift
    recursion program) folds the public side itself.

The ctrl group (round one-hots, permutation index ramp, boundary flags)
is STATIC per po2: the control root is the keccak circuit's identity.
Batch capacity: floor(N / 24) permutations per segment.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import field as F
from ..core import ntt as NTT
from . import dsl
from ..prover.stark import ExtVal, VecVal

ROUNDS = 24
LANES = 25
LANE_BITS = 64
STATE_BITS = LANES * LANE_BITS  # 1600
LIMBS = 100  # 16-bit limbs per state
ENTRIES = LIMBS  # public entries per permutation (2 limbs each)
PORTS = 5  # LogUp ports per row (5 * 24 >= 100 entries)
TAG_STATE = 8  # publics tag (disjoint from rv32im TAG space)

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
ROTATION = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _abit(x: int, y: int, z: int) -> int:
    return LANE_BITS * (5 * y + x) + z


class _Alloc:
    def __init__(self):
        self.n = 0

    def get(self, count=1):
        start = self.n
        self.n += count
        return start if count == 1 else slice(start, start + count)


class DataCols:
    def __init__(self):
        a = _Alloc()
        self.a = a.get(STATE_BITS)
        self.c1 = a.get(320)
        self.c2 = a.get(320)
        self.b = a.get(STATE_BITS)
        self.in_limbs = a.get(LIMBS)
        self.out_limbs = a.get(LIMBS)
        self.pad = a.get(4048 - a.n)
        self.total = a.n


class CtrlCols:
    def __init__(self):
        a = _Alloc()
        self.is_first = a.get()
        self.not_last = a.get()
        self.rr = a.get(ROUNDS)  # round one-hot within the permutation
        self.perm = a.get()  # permutation index ramp (0..K-1)
        self.active = a.get()  # row belongs to a full permutation
        self.pad = a.get(32 - a.n)
        self.total = a.n


class AccumCols:
    def __init__(self):
        self.inv = [4 * i for i in range(PORTS)]
        self.running = 4 * PORTS
        self.total = 4 * PORTS + 4  # 24


DC = DataCols()
CC = CtrlCols()
AC = AccumCols()


def max_perms(po2: int) -> int:
    return (1 << po2) // ROUNDS


@dataclasses.dataclass
class PublicValues:
    """states: (KMAX, 1 + 2*LIMBS) — [mask, in limb0..99, out limb0..99]
    per permutation slot (canonical 16-bit limb values, Montgomery)."""

    states: torch.Tensor


def public_logup_sum(pub: PublicValues, gamma, delta):
    """Public side of the state-binding port: for each perm k and entry
    slot s < 100: mask / (gamma - (TAG + d*(100k+s) + d2*lo + d3*hi))."""
    dev = pub.states.device
    dpows = NTT.ext_powers(delta, 4)
    kmax = pub.states.shape[0]
    shape = (kmax, ENTRIES, 4)
    mask = pub.states[:, 0]
    limbs = pub.states[:, 1:].reshape(kmax, ENTRIES, 2)
    seq = F.fp(np.arange(kmax * ENTRIES).reshape(kmax, ENTRIES), dev)
    acc = F.ext_from_base(torch.full((kmax, ENTRIES), F.mont(TAG_STATE),
                                     dtype=F.I32, device=dev))
    acc = F.ext_add(acc, F.ext_scale(dpows[1].expand(shape), seq))
    acc = F.ext_add(acc, F.ext_scale(dpows[2].expand(shape), limbs[..., 0]))
    acc = F.ext_add(acc, F.ext_scale(dpows[3].expand(shape), limbs[..., 1]))
    den = F.ext_sub(gamma.expand(shape), acc)
    terms = F.ext_scale(F.ext_inv(den), mask[:, None])
    return F.sum_mod(F.sum_mod(terms, 1), 0)


class _Rows:
    def __init__(self, cols: dsl.Columns):
        self._cols = cols

    def data(self, i):
        return self._cols.data[i]

    def ctrl(self, i):
        return self._cols.ctrl[i]

    def datab(self, idx):
        return self._cols.data.block(idx)

    def ctrlb(self, idx):
        return self._cols.ctrl.block(idx)


class KeccakAir(dsl.Air):
    name = "keccak"
    ctrl_cols = CC.total
    data_cols = DC.total
    accum_cols = AC.total
    globals_count = 2  # gamma, delta
    max_degree = 5
    ctrl_dynamic = False  # static batch layout: ctrl root == circuit id

    def ctrl_trace(self, n: int, device="cpu"):
        ct = np.zeros((n, CC.total), dtype=np.int64)
        ct[0, CC.is_first] = 1
        ct[: n - 1, CC.not_last] = 1
        t = np.arange((n // ROUNDS) * ROUNDS)
        ct[t, CC.rr.start + t % ROUNDS] = 1
        ct[t, CC.perm] = t // ROUNDS
        ct[t, CC.active] = 1
        return F.fp(ct, device)

    def accum_trace(self, ctrl, data, globals_):
        gamma, delta = globals_[0], globals_[1]
        dpows = NTT.ext_powers(delta, 4)
        n = data.shape[0]
        alg = dsl.BaseAlg(data.device)
        rows = _Rows(dsl.Columns(_Acc(ctrl), _Acc(data), None))
        packs, sels = _ports(alg, rows, gamma, dpows)
        out = torch.zeros((n, AC.total), dtype=F.I32, device=data.device)
        invs = F.ext_inv(torch.stack([p.expand(n, 4) for p in packs]))
        total = torch.zeros((n, 4), dtype=F.I32, device=data.device)
        for j in range(PORTS):
            inv = F.ext_scale(invs[j], sels[j])
            out[:, AC.inv[j]: AC.inv[j] + 4] = inv
            total = F.ext_add(total, inv)
        # exact prefix sum: N terms < 2^31 stay below 2^63 in int64
        running = (total.to(torch.int64).cumsum(0) % F.P).to(F.I32)
        out[:, AC.running: AC.running + 4] = running
        return out

    def constraints(self, alg, now, nxt, globals_, pub: PublicValues):
        gamma, delta = globals_[0], globals_[1]
        dpows = alg.ext_powers(delta, 4)
        d = _Rows(now)
        nx = _Rows(nxt)
        c = []
        sub = alg.sub
        one = alg.one()
        gm, ga, gs = alg.gmul, alg.gadd, alg.gsub
        B = alg.B

        active = d.ctrl(CC.active)
        not_last = d.ctrl(CC.not_last)
        rr = [d.ctrl(CC.rr.start + i) for i in range(ROUNDS)]
        rr_blk = d.ctrlb(CC.rr)
        not_perm_end = sub(active, rr[ROUNDS - 1])

        def gxor3_(A, Bq, Cq):
            ab = gm(A, Bq)
            ac = gm(A, Cq)
            bc = gm(Bq, Cq)
            pair = ga(ga(ab, ac), bc)
            tri = gm(ab, Cq)
            lin = ga(ga(A, Bq), Cq)
            four_tri = ga(ga(tri, tri), ga(tri, tri))
            return ga(gs(lin, ga(pair, pair)), four_tri)

        def gxor2(A, Bq):
            ab = gm(A, Bq)
            return gs(ga(A, Bq), ga(ab, ab))

        # ---- booleans (grouped) ----
        bool_cols = (list(range(DC.a.start, DC.a.stop))
                     + list(range(DC.c1.start, DC.c1.stop))
                     + list(range(DC.c2.start, DC.c2.stop))
                     + list(range(DC.b.start, DC.b.stop)))
        bools = d.datab(bool_cols)
        ones_g = alg.gconst(np.ones(len(bool_cols), dtype=np.int64))
        c.append(VecVal(gm(bools, gs(bools, ones_g))))

        T = _index_tables()
        # ---- theta helpers: c1 = XOR3(a row0..2), C = XOR3(c1, a3, a4)
        c.append(VecVal(gs(d.datab(T["c1"]),
                           gxor3_(d.datab(T["a_y0"]), d.datab(T["a_y1"]),
                                  d.datab(T["a_y2"])))))
        c.append(VecVal(gs(d.datab(T["c2"]),
                           gxor3_(d.datab(T["c1"]), d.datab(T["a_y3"]),
                                  d.datab(T["a_y4"])))))
        # ---- b = rho/pi(a ^ D): b[target] = XOR3(a, C[x-1,z], C[x+1,z-1])
        c.append(VecVal(gs(d.datab(T["b_tgt"]),
                           gxor3_(d.datab(T["a_all"]),
                                  d.datab(T["c_xm1"]),
                                  d.datab(T["c_xp1"])))))
        # ---- chi (+ iota on lane (0,0)) transition, gated in-perm ----
        # grouped over all 1600 state bits: iota rides an all-bits xor
        # against a vector that is zero outside lane (0,0), and
        # xor2(e, 0) == e exactly.
        rc_grp = [alg.gweighted(rr_blk, T["rc_bits"][:, z])
                  for z in range(LANE_BITS)]
        B0 = d.datab(T["b_all"])
        B1 = d.datab(T["b_x1"])
        B2 = d.datab(T["b_x2"])
        ones1600 = alg.gconst(np.ones(STATE_BITS, dtype=np.int64))
        Q = gm(gs(ones1600, B1), B2)
        E = gxor2(B0, Q)
        zero_s = alg.zero()
        rc_vec = alg.stack(
            [rc_grp[j] if j < LANE_BITS else zero_s
             for j in range(STATE_BITS)])  # lane (0,0) = bits 0..63
        e_grp = gxor2(E, rc_vec)
        c.append(VecVal(gm(B(not_perm_end),
                           gs(nx.datab(slice(DC.a.start, DC.a.stop)),
                              e_grp))))

        # ---- limb carry + boundary binding ----
        in_l = d.datab(DC.in_limbs)
        out_l = d.datab(DC.out_limbs)
        c.append(VecVal(gm(B(not_perm_end), gs(nx.datab(DC.in_limbs),
                                               in_l))))
        c.append(VecVal(gm(B(not_perm_end), gs(nx.datab(DC.out_limbs),
                                               out_l))))
        W16 = np.array([1 << i for i in range(16)], dtype=np.int64)
        in_binds = []
        out_binds = []
        for lane in range(LANES):
            for s_ in range(4):
                lo = LANE_BITS * lane + 16 * s_
                in_binds.append(alg.gweighted(
                    d.datab(list(range(DC.a.start + lo,
                                       DC.a.start + lo + 16))), W16))
                # grouped 16-bit slice of the chi output
                out_binds.append(alg.gweighted(
                    alg.gslice(e_grp, lo, lo + 16), W16))
        c.append(VecVal(gm(B(rr[0]), gs(in_l, alg.stack(in_binds)))))
        # at the last round, e_grp IS the permutation output (iota of
        # round 23 rides rc_grp through the rr one-hot)
        c.append(VecVal(gm(B(rr[ROUNDS - 1]),
                           gs(out_l, alg.stack(out_binds)))))

        # ---- LogUp ports ----
        packs, sels = _ports(alg, d, gamma, dpows)
        for j in range(PORTS):
            inv = alg.read_ext(now.accum, AC.inv[j])
            c.append(ExtVal(alg.esub(alg.emul(inv, packs[j]),
                                     alg.lift(sels[j]))))
        R_now = alg.read_ext(now.accum, AC.running)
        R_nxt = alg.read_ext(nxt.accum, AC.running)

        def total_of(acc_accessor):
            acc = None
            for j in range(PORTS):
                iv = alg.read_ext(acc_accessor, AC.inv[j])
                acc = iv if acc is None else alg.eadd(acc, iv)
            return acc

        is_first = d.ctrl(CC.is_first)
        is_last = sub(one, not_last)
        c.append(ExtVal(alg.escale(
            alg.esub(alg.esub(R_nxt, R_now), total_of(nxt.accum)),
            not_last)))
        c.append(ExtVal(alg.escale(
            alg.esub(R_now, total_of(now.accum)), is_first)))
        if getattr(alg, "is_prog", False):
            s_pub = _public_sum_prog(alg, pub, gamma, delta)
        elif getattr(alg, "s_pub_const", None) is not None:
            # degree algebra: the public sum is a constant of the row
            s_pub = alg.s_pub_const
        else:
            s_pub = public_logup_sum(pub, gamma, delta)
        c.append(ExtVal(alg.escale(
            alg.esub(R_now, alg.bc(s_pub, R_now)), is_last)))
        return c


@functools.lru_cache(maxsize=1)
def _index_tables():
    """Static column-index tables for the grouped constraint families."""
    c1 = []
    a_y = [[] for _ in range(5)]
    for x in range(5):
        for z in range(LANE_BITS):
            c1.append(DC.c1.start + LANE_BITS * x + z)
            for y in range(5):
                a_y[y].append(DC.a.start + _abit(x, y, z))
    c2 = [DC.c2.start + (i - DC.c1.start) for i in c1]
    b_tgt, a_all, c_xm1, c_xp1 = [], [], [], []
    for x in range(5):
        for y in range(5):
            for z in range(LANE_BITS):
                bx, by = y, (2 * x + 3 * y) % 5
                b_tgt.append(DC.b.start
                             + _abit(bx, by, (z + ROTATION[x][y])
                                     % LANE_BITS))
                a_all.append(DC.a.start + _abit(x, y, z))
                c_xm1.append(DC.c2.start + LANE_BITS * ((x - 1) % 5) + z)
                c_xp1.append(DC.c2.start + LANE_BITS * ((x + 1) % 5)
                             + ((z - 1) % LANE_BITS))
    # chi source order mirrors the a-bit layout: index = _abit(x, y, z)
    b_all = [0] * STATE_BITS
    b_x1 = [0] * STATE_BITS
    b_x2 = [0] * STATE_BITS
    for x in range(5):
        for y in range(5):
            for z in range(LANE_BITS):
                i = _abit(x, y, z)
                b_all[i] = DC.b.start + _abit(x, y, z)
                b_x1[i] = DC.b.start + _abit((x + 1) % 5, y, z)
                b_x2[i] = DC.b.start + _abit((x + 2) % 5, y, z)
    rc_bits = np.zeros((ROUNDS, LANE_BITS), dtype=np.int64)
    for r_ in range(ROUNDS):
        for z in range(LANE_BITS):
            rc_bits[r_, z] = (RC[r_] >> z) & 1
    return dict(c1=c1, c2=c2, a_y0=a_y[0], a_y1=a_y[1], a_y2=a_y[2],
                a_y3=a_y[3], a_y4=a_y[4], b_tgt=b_tgt, a_all=a_all,
                c_xm1=c_xm1, c_xp1=c_xp1, b_all=b_all, b_x1=b_x1,
                b_x2=b_x2, rc_bits=rc_bits)


class _Acc:
    """Column accessor over a raw (N, C) tensor."""

    def __init__(self, arr):
        self._a = arr

    def __getitem__(self, i):
        return self._a[:, i]

    def block(self, idx):
        if isinstance(idx, slice):
            return self._a[:, idx]
        return self._a[:, torch.as_tensor(idx, device=self._a.device)]


def _ports(alg, d, gamma, dpows):
    """5 state-binding LogUp ports: port j at round rr emits entry
    seq = 100*perm + 5*rr + j with value (limb[2s], limb[2s+1]) where
    s = 5*rr + j, for s < 100 (selector = sum of the active rr flags)."""
    m, add = alg.mul, alg.add
    perm = d.ctrl(CC.perm)
    rr = [d.ctrl(CC.rr.start + i) for i in range(ROUNDS)]
    limbs = [d.data((DC.in_limbs.start + i) if i < LIMBS
                    else (DC.out_limbs.start + i - LIMBS))
             for i in range(2 * LIMBS)]
    packs = []
    sels = []
    for j in range(PORTS):
        # slot index / values as one-hot mixes over rr
        slot = lo = hi = sel = None
        for r_ in range(ROUNDS):
            s_ = PORTS * r_ + j
            if s_ >= ENTRIES:
                break
            term = m(rr[r_], alg.const(s_))
            slot = term if slot is None else add(slot, term)
            lo_t = m(rr[r_], limbs[2 * s_])
            hi_t = m(rr[r_], limbs[2 * s_ + 1])
            lo = lo_t if lo is None else add(lo, lo_t)
            hi = hi_t if hi is None else add(hi, hi_t)
            sel = rr[r_] if sel is None else add(sel, rr[r_])
        seq = add(m(perm, alg.const(ENTRIES)), slot)
        comps = alg.stack([seq, lo, hi])
        base = alg.esub(gamma, alg.ext_const([TAG_STATE, 0, 0, 0]))
        acc = alg.gweighted_ext(comps, dpows[1:4])
        packs.append(alg.esub(alg.bc(base, acc), acc))
        sels.append(m(d.ctrl(CC.active), sel))
    return packs, sels


def _public_sum_prog(alg, pub, gamma, delta):
    """Wire-algebra public sum (the keccak-lift program's side)."""
    p = alg.p
    dpows = alg.ext_powers(delta, 4)
    total = None
    for k, row in enumerate(pub.states):
        mask = row[0]
        for s_ in range(ENTRIES):
            lo, hi = row[1 + 2 * s_], row[2 + 2 * s_]
            acc = p.addc(
                p.add(p.mul(dpows[1], p.const(ENTRIES * k + s_)),
                      p.add(p.mul(dpows[2], lo), p.mul(dpows[3], hi))),
                (TAG_STATE, 0, 0, 0))
            t = p.mul(mask, p.inv(p.sub(gamma, acc)))
            total = t if total is None else p.add(total, t)
    return total


AIR = KeccakAir()


# ---------------------------------------------------------------------------
# Witness generation (host, numpy)
# ---------------------------------------------------------------------------


def _rotl(v: int, r: int) -> int:
    return (v << r | v >> (64 - r)) & _M64 if r else v


def keccak_f1600(lanes):
    """Reference permutation on 25 u64 lanes (row-major y*5+x)."""
    A = [[lanes[5 * y + x] for y in range(5)] for x in range(5)]
    for rnd in range(ROUNDS):
        A, _ = _round(A, rnd)
    return [A[x][y] for y in range(5) for x in range(5)]


def _round(A, rnd: int):
    """One round on the (x, y) lane grid -> (next A, the round's helper
    lanes (t1, C, Bm)); t1 = the first three rows' xor, C the column
    parity, Bm the post-theta/rho/pi grid."""
    t1 = [A[x][0] ^ A[x][1] ^ A[x][2] for x in range(5)]
    C = [t1[x] ^ A[x][3] ^ A[x][4] for x in range(5)]
    D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
    Bm = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            Bm[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y] ^ D[x], ROTATION[x][y])
    nxt = [[Bm[x][y] ^ ((~Bm[(x + 1) % 5][y] & _M64) & Bm[(x + 2) % 5][y])
            for y in range(5)] for x in range(5)]
    nxt[0][0] ^= RC[rnd]
    return nxt, (t1, C, Bm)


def _bits(lanes) -> np.ndarray:
    """u64 values (..., L) -> their bits (..., L * 64), bit z of lane l at
    64*l + z."""
    v = np.asarray(lanes, dtype=np.uint64)
    bits = (v[..., None] >> np.arange(LANE_BITS, dtype=np.uint64)) & 1
    return bits.reshape(v.shape[:-1] + (-1,)).astype(np.int64)


def _limbs16(lanes) -> list:
    return [(lanes[L] >> (16 * s_)) & 0xFFFF
            for L in range(LANES) for s_ in range(4)]


def witness(states, po2: int):
    """states: list of 25-lane u64 lists (one per permutation).

    Returns (data (N, DC.total) int64, pub dict with 'states' table,
    out_states list)."""
    n = 1 << po2
    kmax = n // ROUNDS
    assert len(states) <= kmax, "too many permutations for this po2"
    # the batch layout is static (ctrl is the circuit id), so unused
    # permutation slots run the zero state (a legal permutation)
    states = list(states) + [[0] * LANES
                             for _ in range(kmax - len(states))]
    data = np.zeros((n, DC.total), dtype=np.int64)
    pub = np.zeros((kmax, 1 + 2 * LIMBS), dtype=np.int64)
    outs = []
    for k, lanes in enumerate(states):
        lanes = [int(v) & _M64 for v in lanes]
        A = [[lanes[5 * y + x] for y in range(5)] for x in range(5)]
        a_l, t1_l, c_l, b_l = [], [], [], []
        for rnd in range(ROUNDS):
            a_l.append([A[x][y] for y in range(5) for x in range(5)])
            A, (t1, C, Bm) = _round(A, rnd)
            t1_l.append(t1)
            c_l.append(C)
            b_l.append([Bm[x][y] for y in range(5) for x in range(5)])
        rows = data[ROUNDS * k: ROUNDS * (k + 1)]
        rows[:, DC.a] = _bits(a_l)
        rows[:, DC.c1] = _bits(t1_l)
        rows[:, DC.c2] = _bits(c_l)
        rows[:, DC.b] = _bits(b_l)
        out_lanes = [A[x][y] for y in range(5) for x in range(5)]
        outs.append(out_lanes)
        in_limbs, out_limbs = _limbs16(lanes), _limbs16(out_lanes)
        rows[:, DC.in_limbs] = in_limbs
        rows[:, DC.out_limbs] = out_limbs
        pub[k, 0] = 1
        pub[k, 1: 1 + LIMBS] = in_limbs
        pub[k, 1 + LIMBS:] = out_limbs
    return data, dict(states=pub), outs
