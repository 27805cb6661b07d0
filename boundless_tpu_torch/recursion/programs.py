"""In-circuit STARK verifier: recursion-VM programs that verify proofs.

Counterpart of `boundless_tpu/recursion/programs.py`: the same wire
program for the same (inner AIR, po2, proof system), built over the
port's AIRs, and the same witness stream from the port's `SegmentProof`.

This is the succinct-recursion core — the TPU-native analogue of risc0's
recursion-circuit programs (lift/join/union/resolve), which are STARK
verifiers expressed in the recursion VM (`risc0-circuit-recursion-sys`,
SURVEY.md §2.4; invoked via `ProverServer::{lift,join,...}` at
`prover/crates/workflow/src/tasks/{prove,join}.rs`).

`StarkVerifier.build()` emits a `vm.Prog` that replays, wire for wire,
exactly what `prover.stark.verify` does for a *statically known*
(inner AIR shape, po2, proof system):

  transcript replay -> challenge extraction -> DEEP-ALI check at z
  (inner AIR constraints re-evaluated through `ProgAlg`, the wire
  algebra) -> FRI fold verification -> Merkle openings of every
  committed group -> DEEP combo recomputation at each query point.

The proof itself is the program's witness (INPUT wires), serialized by
`serialize_proof` in the exact order `build()` consumes it. The
program's public values bind:

  group 0-1: inner proof's public-values digest (8 words)
  group 2-3: inner circuit's control root (8 words)
  group 4-5: free for claim semantics (lift/join programs layer them)

Soundness shape: everything the host verifier checks with `==` becomes
an AZ assert; a witness stream that is not a valid proof makes the
program's data trace unsatisfiable (vm.EvalError at witness-gen time,
constraint violation at proof time).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import field as F
from ..core import fri
from ..core import poseidon2_np as P2NP
from ..air.dsl import Columns, ExtVal, VecVal
from . import vm

P = F.P
CHECK_SPLIT = 4
CHECK_COLS = 16


# ---------------------------------------------------------------------------
# Generic wire macros
# ---------------------------------------------------------------------------


def select_digest(p: vm.Prog, b: int, x2, y2):
    """b ? x2 : y2 over packed digest pairs."""
    return (p.select(b, x2[0], y2[0]), p.select(b, x2[1], y2[1]))


def hash_pair(p: vm.Prog, left2, right2):
    """In-circuit P2.hash_pair: digests left/right -> digest (2 wires)."""
    p.p_zero()
    p.p_absorb(left2[0], 0)
    p.p_absorb(left2[1], 1)
    p.p_absorb(right2[0], 2)
    p.p_absorb(right2[1], 3)
    p.p_rounds()
    return (p.p_out(0), p.p_out(1))


def merkle_check(p: vm.Prog, row_wires, total_elems: int, idx_bits,
                 root2, path_wires):
    """Verify a Merkle opening (mirrors merkle.verify_rows).

    path_wires: [(sib0, sib1)] * depth, leaf level first. Must be called
    outside any in-flight transcript absorb phase (uses the sponge).
    """
    cur = p.hash_packed(row_wires, total_elems)
    assert len(path_wires) == len(idx_bits)
    for bit, sib in zip(idx_bits, path_wires):
        left = select_digest(p, bit, sib, cur)
        right = select_digest(p, bit, cur, sib)
        cur = hash_pair(p, left, right)
    p.assert_eq(cur[0], root2[0])
    p.assert_eq(cur[1], root2[1])


def exp_from_bits(p: vm.Prog, bits, base: int) -> int:
    """base^(Σ 2^i b_i) as Π (b_i ? base^{2^i} : 1); one mul per bit."""
    acc = None
    for i, b in enumerate(bits):
        c = pow(base, 1 << i, P)
        # b ? c : 1  ==  1 + b*(c-1)
        term = p.gen(b, ca=(c - 1) % P, imm=(1, 0, 0, 0))
        acc = term if acc is None else p.mul(acc, term)
    return acc if acc is not None else p.one()


def mux(p: vm.Prog, wires: Sequence[int], bits) -> int:
    """wires[Σ 2^i b_i] by select tournament (len(wires) = 2^len(bits))."""
    assert len(wires) == 1 << len(bits)
    cur = list(wires)
    for b in bits:
        cur = [p.select(b, cur[2 * i + 1], cur[2 * i])
               for i in range(len(cur) // 2)]
    return cur[0]


def wire_powers(p: vm.Prog, x: int, count: int) -> List[int]:
    """[x^0 .. x^{count-1}] wires (x^0 = one)."""
    out = [p.one()]
    for _ in range(count - 1):
        out.append(p.mul(out[-1], x))
    return out


def pow2k(p: vm.Prog, x: int, k: int) -> int:
    """x^(2^k) by repeated squaring."""
    for _ in range(k):
        x = p.mul(x, x)
    return x


# ---------------------------------------------------------------------------
# ProgAlg: the wire algebra (mirror of dsl.ExtAlg over Prog wires)
# ---------------------------------------------------------------------------


class ProgAlg:
    """Algebra whose values are recursion-VM wires (ext elements).

    Drop-in for `dsl.ExtAlg` in `Air.constraints`: evaluating the inner
    AIR's constraints under ProgAlg emits the wire ops that compute them
    at the DEEP point inside the recursion circuit. Groups are Python
    lists of wires. Public values must be provided as wires.
    """

    is_ext = True
    is_prog = True  # AIRs may branch to wire-friendly public-value paths

    def __init__(self, p: vm.Prog):
        self.p = p

    def const(self, c: int):
        return self.p.const(int(c) % P)

    def add(self, x, y):
        return self.p.add(x, y)

    def sub(self, x, y):
        return self.p.sub(x, y)

    def mul(self, x, y):
        return self.p.mul(x, y)

    def neg(self, x):
        return self.p.gen(x, ca=P - 1)

    def one(self):
        return self.p.one()

    def zero(self):
        return self.p.const(0)

    def lift(self, b):
        return b

    emul = mul
    eadd = add
    esub = sub
    escale = mul
    eneg = neg

    def read_ext(self, accessor, base_idx: int):
        """Σ_c tap[base_idx+c] * X^c (mirrors ExtAlg.read_ext)."""
        acc = None
        for c in range(4):
            w = accessor[base_idx + c]
            t = w if c == 0 else self.p._mul_basis(w, c, 1)
            acc = t if acc is None else self.p.add(acc, t)
        return acc

    def stack(self, items):
        return list(items)

    def gsize(self, group):
        return len(group)

    def pubval(self, x):
        return x  # pub entries are wires already

    # --- algebra-pure helpers (mirror BaseAlg/ExtAlg) ---

    def ext_const(self, vec):
        return self.p.const(tuple(int(v) % P for v in np.asarray(
            vec).reshape(-1)))

    def ext_powers(self, x, n: int):
        return wire_powers(self.p, x, n)

    def einv(self, e):
        return self.p.inv(e)

    def bc(self, e, like):
        return e  # wires don't broadcast

    # --- grouped ops: groups are lists of wires ---

    def B(self, s):
        return s

    def gconst(self, vec):
        return [self.const(int(v)) for v in np.asarray(vec).reshape(-1)]

    def _pairwise(self, op, x, y):
        if isinstance(x, list) and isinstance(y, list):
            assert len(x) == len(y)
            return [op(a, b) for a, b in zip(x, y)]
        if isinstance(x, list):
            return [op(a, y) for a in x]
        return [op(x, b) for b in y]

    def gmul(self, x, y):
        return self._pairwise(self.p.mul, x, y)

    def gadd(self, x, y):
        return self._pairwise(self.p.add, x, y)

    def gsub(self, x, y):
        return self._pairwise(self.p.sub, x, y)

    def gsum(self, x):
        acc = None
        for w in x:
            acc = w if acc is None else self.p.add(acc, w)
        return acc if acc is not None else self.zero()

    def gweighted_ext(self, x, w_ext):
        """Σ_g w_ext[g] * x_g — both lists of ext wires."""
        acc = None
        for wi, xi in zip(w_ext, x):
            t = self.p.mul(wi, xi)
            acc = t if acc is None else self.p.add(acc, t)
        return acc if acc is not None else self.zero()

    def gweighted(self, x, w_vec):
        w = np.asarray(w_vec).reshape(-1)
        acc = None
        for wi, xi in zip(w, x):
            wi = int(wi) % P
            if wi == 0:
                continue
            t = self.p.gen(xi, ca=wi)
            acc = t if acc is None else self.p.add(acc, t)
        return acc if acc is not None else self.zero()

    def gslice(self, x, a, b):
        return list(x[a:b])

    def gshift_sll(self, x, s):
        z = self.zero()
        return ([z] * s + list(x[: len(x) - s])) if s else list(x)

    def gshift_srl(self, x, s):
        z = self.zero()
        return (list(x[s:]) + [z] * s) if s else list(x)

    def gshift_sra(self, x, s):
        return (list(x[s:]) + [x[-1]] * s) if s else list(x)

    def gconcat(self, groups):
        out = []
        for g in groups:
            out.extend(g)
        return out

    def gpub(self, vec):
        return list(vec)  # wires


class _WireTaps:
    """accessor[i] -> tap wire of base column i at a fixed point index."""

    def __init__(self, taps: List[List[int]], pt: int):
        self._taps = taps
        self._pt = pt

    def __getitem__(self, i):
        return self._taps[i][self._pt]

    def block(self, idx):
        if isinstance(idx, slice):
            return [self._taps[i][self._pt]
                    for i in range(*idx.indices(len(self._taps)))]
        return [self._taps[i][self._pt] for i in idx]


def combine_constraints_prog(p: vm.Prog, cons, alpha: int,
                             keep=None) -> int:
    """Mirror of stark.combine_constraints at the DEEP point, on wires.

    `keep` (blinding divisor classes): only flagged items enter the sum;
    α-power indices are assigned over the FULL list either way."""
    sizes = []
    for c in cons:
        sizes.append(len(c.v) if isinstance(c, VecVal) else 1)
    apows = wire_powers(p, alpha, sum(sizes))
    acc = None
    k = 0
    for i, c in enumerate(cons):
        if keep is not None and not keep[i]:
            k += sizes[i]
            continue
        if isinstance(c, VecVal):
            for w in c.v:
                t = p.mul(apows[k], w)
                acc = t if acc is None else p.add(acc, t)
                k += 1
        else:
            w = c.v if isinstance(c, ExtVal) else c
            t = p.mul(apows[k], w)
            acc = t if acc is None else p.add(acc, t)
            k += 1
    return acc


# ---------------------------------------------------------------------------
# The in-circuit verifier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifierResult:
    """Wires of interest exposed by the built verifier."""

    pub_wires: List[int]         # inner public values (flat, packed 4/wire)
    pub_digest: Tuple[int, int]
    ctrl_root: Optional[Tuple[int, int]]
    prog: vm.Prog


class StarkVerifier:
    """Builds the in-circuit verifier for one (air, po2, ps) instance.

    `air` supplies the static shape and the constraint definition; its
    constraints must be expressible through the dsl algebra alone (true
    for the AIRs in this repo; audited by the parity test).
    `pub_len` is the flattened public-element count of the inner proof
    (fields in declaration order, the flattening the transcript's
    `mix_pub` hashes).
    """

    def __init__(self, air, po2: int, ps, pub_len: int,
                 prog: Optional[vm.Prog] = None,
                 bind_pub_groups: bool = True):
        self.air = air
        self.po2 = po2
        self.ps = ps
        self.pub_len = pub_len
        self.n = 1 << po2
        self.big = ps.commit_expand * self.n
        self.p = prog if prog is not None else vm.Prog(f"verify-{air.name}")
        self.bind = bind_pub_groups

    # -- helpers ----------------------------------------------------------

    def _in(self):
        return self.p.input()

    def _digest_in(self):
        return (self._in(), self._in())

    def _packed_in(self, nelems: int) -> List[int]:
        return [self._in() for _ in range(-(-nelems // 4))]

    # -- the build --------------------------------------------------------

    def build(self) -> VerifierResult:
        p = self.p
        air = self.air
        ps = self.ps
        has_ctrl = air.ctrl_cols > 0
        has_accum = air.accum_cols > 0

        # --- inner public values + digest ---
        pub_wires = self._packed_in(self.pub_len)
        if self.pub_len:
            pub_digest = p.hash_packed(pub_wires, self.pub_len)
        else:
            z = p.const(0)
            pub_digest = (z, z)
        if self.bind:
            p.assert_eq(pub_digest[0], p.pub(0))
            p.assert_eq(pub_digest[1], p.pub(1))

        # --- transcript replay ---
        p.t_init()
        p.t_mix_digest(pub_digest)
        ctrl_root = None
        if has_ctrl:
            ctrl_root = self._digest_in()
            if self.bind:
                p.assert_eq(ctrl_root[0], p.pub(2))
                p.assert_eq(ctrl_root[1], p.pub(3))
            p.t_mix_digest(ctrl_root)
        data_root = self._digest_in()
        p.t_mix_digest(data_root)
        globals_ = [p.t_sample_ext() for _ in range(air.globals_count)]
        accum_root = None
        if has_accum:
            accum_root = self._digest_in()
            p.t_mix_digest(accum_root)
        alpha = p.t_sample_ext()
        check_root = self._digest_in()
        p.t_mix_digest(check_root)
        z = p.t_sample_ext()

        # --- taps ---
        group_cols = [c for c in (air.ctrl_cols if has_ctrl else 0,
                                  air.data_cols,
                                  air.accum_cols if has_accum else 0) if c]
        taps: List[List[int]] = []  # [col][pt] over concatenated groups
        for cols in group_cols:
            for _ in range(cols):
                taps.append([self._in(), self._in()])
        taps_check = [self._in() for _ in range(CHECK_COLS)]
        flat = [w for col in taps for w in col] + taps_check
        p.t_mix_elems(flat, 4 * len(flat))
        beta = p.t_sample_ext()

        # --- DEEP points ---
        g_n = F.ROU_FWD[self.n.bit_length() - 1]
        zg = p.gen(z, ca=g_n)
        z4 = pow2k(p, z, 2)

        # --- ALI at z: inner constraints through the wire algebra ---
        alg = ProgAlg(p)
        ct = sum(group_cols)
        off = 0
        group_taps = []
        for cols in group_cols:
            group_taps.append(taps[off : off + cols])
            off += cols
        gi = iter(group_taps)
        taps_ctrl_w = next(gi) if has_ctrl else None
        taps_data_w = next(gi)
        taps_accum_w = next(gi) if has_accum else None
        now = Columns(
            _WireTaps(taps_ctrl_w, 0) if has_ctrl else None,
            _WireTaps(taps_data_w, 0),
            _WireTaps(taps_accum_w, 0) if has_accum else None)
        nxt = Columns(
            _WireTaps(taps_ctrl_w, 1) if has_ctrl else None,
            _WireTaps(taps_data_w, 1),
            _WireTaps(taps_accum_w, 1) if has_accum else None)
        pub_tree = self.unpack_pub(pub_wires)
        cons = air.constraints(alg, now, nxt, globals_, pub_tree)
        zk = air.zk_rows(self.po2) if hasattr(air, "zk_rows") else 0
        if zk:
            # Blinded inner AIR: Z_H * Q == A_trans + A_point * P_Z
            # (mirror of stark.verify; P_Z = vanishing poly of the zk
            # tail rows, a chain of constant-offset muls on wires).
            from ..prover.stark import _zk_root_ints

            zc = getattr(air, "_zclass", None)
            assert zc is not None and len(zc) == len(cons)
            comb_t = combine_constraints_prog(p, cons, alpha, keep=zc)
            comb_p = combine_constraints_prog(
                p, cons, alpha, keep=[not t for t in zc])
            pz = None
            for r in _zk_root_ints(1 << self.po2, zk):
                t = p.addc(z, (P - r, 0, 0, 0))
                pz = t if pz is None else p.mul(pz, t)
            combined = p.add(comb_t, p.mul(comb_p, pz))
        else:
            combined = combine_constraints_prog(p, cons, alpha)

        z_pow_n = pow2k(p, z, self.po2)
        zz = p.addc(z_pow_n, (P - 1, 0, 0, 0))  # z^N - 1
        # Q(z): recombine check taps, then Σ_i z^i Q_i(z^4)
        qs = []
        for i in range(CHECK_SPLIT):
            acc = None
            for c in range(4):
                w = taps_check[i * 4 + c]
                t = w if c == 0 else p._mul_basis(w, c, 1)
                acc = t if acc is None else p.add(acc, t)
            qs.append(acc)
        zpows = wire_powers(p, z, CHECK_SPLIT)
        q_at_z = None
        for i in range(CHECK_SPLIT):
            t = p.mul(zpows[i], qs[i])
            q_at_z = t if q_at_z is None else p.add(q_at_z, t)
        p.assert_eq(combined, p.mul(zz, q_at_z))

        # --- FRI transcript phase ---
        rounds = fri.num_rounds(self.big, ps.fri_min_degree,
                                ps.commit_expand)
        fri_roots = []
        fri_alphas = []
        for _ in range(rounds):
            r2 = self._digest_in()
            fri_roots.append(r2)
            p.t_mix_digest(r2)
            fri_alphas.append(p.t_sample_ext())
        final_m = self.big // (fri.FRI_FOLD ** rounds)
        final_deg = final_m // ps.commit_expand
        final_coeffs = [self._in() for _ in range(final_deg)]
        p.t_mix_elems(final_coeffs, 4 * final_deg)
        bits_total = self.big.bit_length() - 1
        qidx = [p.t_sample_u32_bits(bits_total)[0]
                for _ in range(ps.queries)]  # bit lists, low -> high

        # --- FRI query phase ---
        round0_vals = []
        final_idx_bits = []
        inv16 = pow(fri.FRI_FOLD, P - 2, P)
        for q in range(ps.queries):
            idx_bits = qidx[q]
            value = None
            cur_m, cur_shift = self.big, F.GENERATOR
            for k in range(rounds):
                rows_n = cur_m // fri.FRI_FOLD
                depth = rows_n.bit_length() - 1
                r_bits = idx_bits[:depth]
                t_bits = idx_bits[depth : depth + fri.FRI_FOLD_LOG]
                row = [self._in() for _ in range(fri.FRI_FOLD)]
                path = [self._digest_in() for _ in range(depth)]
                merkle_check(p, row, 4 * fri.FRI_FOLD, r_bits,
                             fri_roots[k], path)
                mine = mux(p, row, t_bits)
                if value is None:
                    round0_vals.append(mine)
                else:
                    p.assert_eq(mine, value)
                # fold at the query group (direct formula)
                w_inv = pow(F.ROU_FWD[cur_m.bit_length() - 1], P - 2, P)
                shift_inv = pow(cur_shift, P - 2, P)
                winv_r = exp_from_bits(p, r_bits, w_inv)
                acc = None
                for t in range(fri.FRI_FOLD):
                    c_t = shift_inv * pow(w_inv, t * rows_n, P) % P
                    xinv_t = p.gen(winv_r, ca=c_t)
                    ax = p.mul(fri_alphas[k], xinv_t)
                    s = p.addc(ax, (1, 0, 0, 0))  # 1 + ax
                    pw = ax
                    for _ in range(fri.FRI_FOLD_LOG - 1):
                        pw = p.mul(pw, pw)
                        s = p.muladd(s, pw, s)  # s * (1 + pw)... see note
                    term = p.mul(row[t], s)
                    acc = term if acc is None else p.add(acc, term)
                value = p.gen(acc, ca=inv16)
                idx_bits = r_bits
                cur_m = rows_n
                cur_shift = pow(cur_shift, fri.FRI_FOLD, P)
            final_idx_bits.append(idx_bits)
            # final polynomial evaluation at the surviving point
            w_fin = F.ROU_FWD[cur_m.bit_length() - 1]
            x_fin = p.gen(exp_from_bits(p, idx_bits, w_fin), ca=cur_shift)
            acc = p.const(0)
            for d in range(final_deg - 1, -1, -1):
                acc = p.muladd(acc, x_fin, final_coeffs[d])
            p.assert_eq(acc, value)

        # --- committed-group openings + DEEP combo at each query ---
        depth_c = self.big.bit_length() - 1
        betas = wire_powers(p, beta, 2 * ct + CHECK_COLS)
        # tap-side weighted sums (query-independent)
        cp = []
        for cls, tap_list in ((0, [col[0] for col in taps]),
                              (1, [col[1] for col in taps]),
                              (2, taps_check)):
            weights = betas[:ct] if cls == 0 else (
                betas[ct : 2 * ct] if cls == 1 else betas[2 * ct :])
            acc = None
            for wgt, tw in zip(weights, tap_list):
                t = p.mul(wgt, tw)
                acc = t if acc is None else p.add(acc, t)
            cp.append(acc if acc is not None else p.const(0))

        for q in range(ps.queries):
            idx_bits = qidx[q]
            opened = {}
            order = []
            if has_ctrl:
                order.append(("ctrl", air.ctrl_cols, ctrl_root))
            order.append(("data", air.data_cols, data_root))
            if has_accum:
                order.append(("accum", air.accum_cols, accum_root))
            order.append(("check", CHECK_COLS, check_root))
            for name, cols, root in order:
                row = self._packed_in(cols)
                path = [self._digest_in() for _ in range(depth_c)]
                merkle_check(p, row, cols, idx_bits, root, path)
                opened[name] = row

            # x at this query index on the commit domain
            w_big = F.ROU_FWD[self.big.bit_length() - 1]
            x_q = p.gen(exp_from_bits(p, idx_bits, w_big),
                        ca=F.GENERATOR)

            trace_row_wires = []
            for name, cols, _ in order[:-1]:
                trace_row_wires.append((opened[name], cols))

            def col_sum(weights, packed_groups):
                """Σ_j w_j * row_j over packed base rows."""
                acc = None
                j = 0
                for wires, cols in packed_groups:
                    for c in range(cols):
                        wgt = weights[j]
                        j += 1
                        t = p.pickmul(wires[c // 4], c % 4, wgt)
                        acc = t if acc is None else p.add(acc, t)
                return acc if acc is not None else p.const(0)

            s_z = col_sum(betas[:ct], trace_row_wires)
            s_zg = col_sum(betas[ct : 2 * ct], trace_row_wires)
            s_ch = col_sum(betas[2 * ct :], [(opened["check"], CHECK_COLS)])

            expected = None
            for cls, (s, point) in enumerate(((s_z, z), (s_zg, zg),
                                              (s_ch, z4))):
                den = p.sub(x_q, point)
                inv_den = p.inv(den)
                num = p.sub(s, cp[cls])
                t = p.mul(num, inv_den)
                expected = t if expected is None else p.add(expected, t)
            p.assert_eq(expected, round0_vals[q])

        return VerifierResult(pub_wires=pub_wires, pub_digest=pub_digest,
                              ctrl_root=ctrl_root, prog=p)

    # -- override point: how packed pub wires become the AIR's pub tree --

    def unpack_pub(self, pub_wires: List[int]):
        """Default: the AIR's constraints receive the packed wire list.

        AIRs whose `constraints` index pub as a flat array of scalars
        need per-element wires: override or wrap (see `ScalarPub`)."""
        return ScalarPub(self.p, pub_wires, self.pub_len)


class ScalarPub:
    """pub[i] -> wire holding flat public element i (base scalar)."""

    def __init__(self, p: vm.Prog, packed: List[int], length: int):
        self.p = p
        self.packed = packed
        self.length = length
        self._cache = {}

    def __getitem__(self, i):
        i = int(i)
        assert 0 <= i < self.length
        if i not in self._cache:
            self._cache[i] = self.p.pick(self.packed[i // 4], i % 4)
        return self._cache[i]


# ---------------------------------------------------------------------------
# Host-side proof serialization (must mirror build() exactly)
# ---------------------------------------------------------------------------


def _canon(a) -> np.ndarray:
    """Montgomery tensor (any device) -> canonical int64 numpy."""
    return F.from_mont(a).cpu().numpy().astype(np.int64)


def _pack4(vals: Sequence[int]) -> List[tuple]:
    vals = list(int(v) for v in vals)
    while len(vals) % 4:
        vals.append(0)
    return [tuple(vals[i : i + 4]) for i in range(0, len(vals), 4)]


def serialize_proof(air, proof, pub_flat: Sequence[int], po2: int, ps
                    ) -> List[tuple]:
    """The witness stream for the verifier program, in consumption order.

    pub_flat: canonical flat public elements of the inner proof (the
    order the transcript's `mix_pub` hashes). The proof is read in the
    leaf order of the JAX package's pytree flattening of its
    SegmentProof, which is the order `build()` consumes it in.
    """
    has_ctrl = proof.ctrl_root is not None
    has_accum = proof.accum_root is not None
    big = ps.commit_expand * (1 << po2)
    out: List[tuple] = []

    out += _pack4(pub_flat)
    if has_ctrl:
        out += _pack4(_canon(proof.ctrl_root))
    out += _pack4(_canon(proof.data_root))
    if has_accum:
        out += _pack4(_canon(proof.accum_root))
    out += _pack4(_canon(proof.check_root))

    for taps in (proof.taps_ctrl, proof.taps_data, proof.taps_accum):
        if taps is None:
            continue
        t = _canon(taps)  # (C, 2, 4)
        for c in range(t.shape[0]):
            out.append(tuple(t[c, 0]))
            out.append(tuple(t[c, 1]))
    tc = _canon(proof.taps_check)  # (16, 4)
    for i in range(CHECK_COLS):
        out.append(tuple(tc[i]))

    fp = proof.fri_proof
    for root in fp.round_roots:
        out += _pack4(_canon(root))
    fc = _canon(fp.final_coeffs)  # (deg, 4)
    for d in range(fc.shape[0]):
        out.append(tuple(fc[d]))

    # FRI query phase: build() iterates queries outermost, rounds inner.
    rows_k = [_canon(r) for r in fp.round_rows]      # (Q, 64) each
    paths_k = [_canon(pth) for pth in fp.round_paths]  # (Q, depth, 8)
    for q in range(ps.queries):
        for k in range(len(fp.round_roots)):
            out += _pack4(rows_k[k][q])
            depth = paths_k[k].shape[1]
            for d in range(depth):
                out += _pack4(paths_k[k][q, d])

    # group openings per query: ctrl, data, accum, check
    openings = []
    if has_ctrl:
        openings.append(proof.open_ctrl)
    openings.append(proof.open_data)
    if has_accum:
        openings.append(proof.open_accum)
    openings.append(proof.open_check)
    rows_g = [_canon(o.rows) for o in openings]
    paths_g = [_canon(o.paths) for o in openings]
    for q in range(ps.queries):
        for rows, paths in zip(rows_g, paths_g):
            out += _pack4(rows[q])
            for d in range(paths.shape[1]):
                out += _pack4(paths[q, d])
    return out


def verifier_pub_vals(pub_flat: Sequence[int], control_root=None
                      ) -> List[int]:
    """Outer public values binding an inner proof: digest + control root.

    `pub_flat`: canonical elements; `control_root`: Montgomery words (a
    tensor on any device, or an array)."""
    digest = (list(P2NP.hash_elems_np(pub_flat)) if len(pub_flat)
              else [0] * 8)
    if control_root is None:
        return digest + [0] * 8
    if not isinstance(control_root, torch.Tensor):
        control_root = torch.from_numpy(
            np.asarray(control_root, dtype=np.int64).astype(np.int32))
    return digest + [int(x) for x in _canon(control_root)]
