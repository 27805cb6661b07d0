"""The Groth16 wrap circuit: an R1CS verifier for the identity_p254 proof.

Mirrors `prover/stark.py:verify` + `core/fri.py:verify` under the
poseidon254 hash suite (core/suites.py) over the RecursionAir
(recursion/air.py) — the same structure `recursion/programs.py
StarkVerifier` expresses over recursion-VM wires, re-expressed over the
sparse R1CS builder (groth16/r1cs.py):

  * transcript + Merkle hashing: NATIVE Poseidon-BN254 (3 constraints
    per S-box) — this is why the final shrink re-proves under the p254
    suite (reference: risc0 identity_p254 feeding the circom Groth16
    circuit, `blake3_groth16/src/prove.rs:33-62`, SURVEY.md §2.4);
  * Baby Bear arithmetic (ALI constraint evaluation, DEEP combo, FRI
    folds): nonnative BB gadgets with lazy-reduction bounds;
  * challenge squeezes: canonical 254-bit decomposition of the sponge
    felt, 62-bit chunks mod P (core/poseidon_bn254.squeeze_bb).

Public inputs: 3 felts = the identity proof's 24 public scalars packed
8-per-felt (claim digest 8 || allowed root 8 || zeros 8). The p254
control id (the identity program's commitment root) is a CONSTANT baked
into the circuit — the Groth16 verifying key therefore pins the whole
recursion lattice.

Counterpart of `boundless_tpu/groth16/circuit.py`, copied over the port's
`core.field`, `core.fri` and `prover.stark`; a proof's tensors (on any
device) are read once into host numpy words before the walk.

Build once with `proof=None` for CRS setup (layout mode), and with a
concrete `P254Receipt` for witness generation; both paths produce the
identical constraint sequence (all control flow is static).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import field as FBB
from ..core import fri
from ..core import poseidon_bn254 as P254
from ..air.dsl import ExtVal, VecVal
from ..prover.stark import CHECK_COLS, CHECK_SPLIT
from . import r1cs
from .r1cs import BB, BBOps, Builder, LC, _lc_add, _lc_scale

P = r1cs.BB_P
Ext = List[BB]  # 4 BB components


class _Bcast:
    """Broadcast marker for group algebra (R1csAlg.B)."""

    def __init__(self, e):
        self.e = e


def _canon_arr(a) -> np.ndarray:
    """Montgomery words (host numpy) -> canonical uint64."""
    return np.asarray(a, dtype=np.uint64) * FBB.R_INV % FBB.P


def _to_host(x):
    """A proof (named tuples of tensors) -> the same shape of uint32
    numpy words (p254 digest words keep their bit patterns)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.uint32)
    if hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# In-circuit transcript (mirror of core/suites.py Transcript254)
# ---------------------------------------------------------------------------


class CircuitTranscript:
    def __init__(self, bld: Builder, ops: BBOps):
        self.b = bld
        self.ops = ops
        self.state: List[LC] = [bld.const_lc(0)] * 3
        self._queue: List[BB] = []

    def mix_digest_felt(self, felt: LC):
        self.state = r1cs.poseidon_perm(
            self.b, [_lc_add(self.state[0], felt), self.state[1],
                     self.state[2]])
        self._queue = []

    def mix_bb_elems(self, elems: List[BB]):
        felts = r1cs.pack_bb_felts(self.b, self.ops, elems)
        self.mix_digest_felt(r1cs.poseidon_hash_felts(self.b, felts))

    def _squeeze(self):
        """Refill the 4-element queue from state[0]; permute after."""
        b = self.b
        s0 = self.state[0]
        v = b.val(s0)
        bits = b.bits_of(s0, 254, value=v)
        self._assert_lt_fr(bits)
        for j in range(P254.CHUNKS_PER_FELT):
            chunk: LC = {}
            for i in range(P254.CHUNK_BITS):
                chunk = _lc_add(chunk, _lc_scale(
                    bits[62 * j + i], 1 << i))
            cb = 62 * j
            cv = None if v is None else (v >> cb) & ((1 << 62) - 1)
            self._queue.append(self._mod_p(chunk, 62, cv))
        # drop the top 6 bits (248..254): unused by squeeze_bb
        self.state = r1cs.poseidon_perm(self.b, self.state)

    def _assert_lt_fr(self, bits: List[LC]):
        """Canonical decomposition: the 254-bit integer must be < FR
        (otherwise two decompositions of the felt exist and the prover
        could steer the challenges). Standard big-endian comparison
        chain against the constant FR - 1 (value <= FR - 1)."""
        b = self.b
        limit = r1cs.FR - 1
        # gt_so_far: 1 if some higher bit had value < limit bit (strictly
        # less established); eq_so_far tracks equality prefix.
        eq: Optional[LC] = None  # None == "all equal so far" (constant 1)
        for i in range(253, -1, -1):
            lb = (limit >> i) & 1
            bit = bits[i]
            if lb == 1:
                # bit may be 0 (becomes strictly less) or 1 (still equal)
                if eq is None:
                    eq = bit
                else:
                    eq = b.mul(eq, bit)
            else:
                # limit bit 0: value bit must be 0 whenever still equal
                if eq is None:
                    b.enforce_zero(bit)
                else:
                    b.enforce(eq, bit, {})
        # (eq may end as the "value == limit" flag; that's allowed)

    def _mod_p(self, chunk: LC, nbits: int, value: Optional[int]) -> BB:
        """chunk (< 2^nbits) mod P as a canonical BB wire."""
        b = self.b
        qmax_bits = max(nbits - 30, 1)
        if value is None:
            qbits = [b.bit(None) for _ in range(qmax_bits)]
            r = self.ops.wit_canonical(None)
        else:
            q = value // P
            qbits = [b.bit((q >> i) & 1) for i in range(qmax_bits)]
            r = self.ops.wit_canonical(value % P)
        qlc: LC = {}
        for i, qb in enumerate(qbits):
            qlc = _lc_add(qlc, _lc_scale(qb, 1 << i))
        b.enforce_zero(_lc_add(chunk, _lc_scale(
            _lc_add(_lc_scale(qlc, P), r.lc), r1cs.FR - 1)))
        return r

    def sample_bb(self) -> BB:
        if not self._queue:
            self._squeeze()
        return self._queue.pop(0)

    def sample_ext(self) -> Ext:
        return [self.sample_bb() for _ in range(4)]

    def sample_idx_bits(self, nbits: int) -> List[LC]:
        """Mirror of Transcript.sample_u32 & mask: low 16 bits from elem
        a, next bits from elem b (both canonical BB)."""
        a = self.sample_bb()
        b_ = self.sample_bb()
        abits = self.b.bits_of(a.lc, 31)
        bbits = self.b.bits_of(b_.lc, 31)
        u32_bits = abits[:16] + bbits[:16]
        return u32_bits[:nbits]


# ---------------------------------------------------------------------------
# Small helpers over BB / Ext
# ---------------------------------------------------------------------------


def ext_read(ops: BBOps, vals4) -> Ext:
    """Witness 4 canonical BB elements (an ext value)."""
    if vals4 is None:
        return [ops.wit_canonical(None) for _ in range(4)]
    return [ops.wit_canonical(int(v)) for v in vals4]


def ext_scale_const(ops: BBOps, e: Ext, c: int) -> Ext:
    return [ops.scale(x, c) for x in e]


def ext_add_base_const(ops: BBOps, e: Ext, c: int) -> Ext:
    return [ops.add(e[0], ops.const(c))] + list(e[1:])


def ext_powers_w(ops: BBOps, x: Ext, n: int) -> List[Ext]:
    out = [ops.ext_const([1, 0, 0, 0])]
    for _ in range(n - 1):
        out.append(ops.ext_mul(out[-1], x))
    return out


def ext_pow2k(ops: BBOps, x: Ext, k: int) -> Ext:
    for _ in range(k):
        x = ops.ext_mul(x, x)
    return x


def select_felt(bld: Builder, b: LC, x: LC, y: LC) -> LC:
    d = _lc_add(x, _lc_scale(y, r1cs.FR - 1))
    t = bld.mul(b, d)
    return _lc_add(y, t)


def mux_ext(bld: Builder, ops: BBOps, items: List[Ext],
            bits: List[LC]) -> Ext:
    """items[idx] with idx given by bits (low first); len = 2^len(bits)."""
    cur = items
    for b in bits:
        nxt = []
        for i in range(0, len(cur), 2):
            nxt.append([BB(select_felt(bld, b, cur[i + 1][c].lc,
                                       cur[i][c].lc),
                           cur[i][c].bound + cur[i + 1][c].bound)
                       for c in range(4)])
        cur = nxt
    return cur[0]


def exp_from_bits(ops: BBOps, bits: List[LC], base: int) -> BB:
    """base^idx as a BB value: product of select(bit, base^{2^i}, 1)."""
    bld = ops.b
    acc: Optional[BB] = None
    cur = base % P
    for b in bits:
        # factor = 1 + b*(cur - 1)
        f = BB(_lc_add(bld.const_lc(1), _lc_scale(b, cur - 1)), P)
        acc = f if acc is None else ops.mul(acc, f)
        cur = cur * cur % P
    return acc if acc is not None else ops.const(1)


def felt_of_words_const(words) -> int:
    return P254.felt_of_words([int(w) for w in np.asarray(words)])


def merkle_check_felt(bld: Builder, tr_ops: BBOps, leaf_elems: List[BB],
                      idx_bits: List[LC], root_felt: LC,
                      path_felts: List[LC]):
    """Recompute the p254 Merkle root from a leaf row + felt path."""
    cur = r1cs.poseidon_hash_felts(
        bld, r1cs.pack_bb_felts(bld, tr_ops, leaf_elems))
    for b, sib in zip(idx_bits, path_felts):
        left = select_felt(bld, b, sib, cur)
        right = select_felt(bld, b, cur, sib)
        cur = r1cs.poseidon_hash_pair(bld, left, right)
    bld.enforce_zero(_lc_add(cur, _lc_scale(root_felt, r1cs.FR - 1)))


# ---------------------------------------------------------------------------
# R1CS algebra for the AIR's DEEP-point constraint evaluation
# ---------------------------------------------------------------------------


class _Taps:
    """accessor[i] -> Ext tap of base column i at a fixed point index."""

    def __init__(self, taps: List[List[Ext]], pt: int):
        self._taps = taps
        self._pt = pt

    def __getitem__(self, i):
        return self._taps[i][self._pt]

    def block(self, idx):
        if isinstance(idx, slice):
            return [self._taps[i][self._pt]
                    for i in range(*idx.indices(len(self._taps)))]
        return [self._taps[i][self._pt] for i in idx]


class _Cols:
    def __init__(self, ctrl, data, accum):
        self.ctrl = ctrl
        self.data = data
        self.accum = accum


class R1csAlg:
    """dsl algebra over Ext values (mirror of programs.ProgAlg: at the
    DEEP point every value is an ext element; groups are Python lists).
    """

    is_ext = True

    def __init__(self, ops: BBOps):
        self.ops = ops

    # scalars (= ext values here)
    def const(self, c: int) -> Ext:
        return self.ops.ext_const([c, 0, 0, 0])

    def add(self, x, y):
        return self.ops.ext_add(x, y)

    def sub(self, x, y):
        return self.ops.ext_sub(x, y)

    def mul(self, x, y):
        return self.ops.ext_mul(x, y)

    def neg(self, x):
        return self.ops.ext_sub(self.const(0), x)

    def one(self):
        return self.const(1)

    def zero(self):
        return self.const(0)

    def lift(self, b):
        return b

    def read_ext(self, accessor, base_idx: int):
        comps = [accessor[base_idx + c] for c in range(4)]
        acc = comps[0]
        for c in range(1, 4):
            acc = self.add(acc, self._mul_basis(comps[c], c))
        return acc

    def _mul_basis(self, e: Ext, c: int) -> Ext:
        """e * X^c in the quartic extension (X^4 = 11)."""
        out = list(e)
        for _ in range(c):
            out = [self.ops.scale(out[3], 11), out[0], out[1], out[2]]
        return out

    def stack(self, items):
        return list(items)

    def pubval(self, x):
        return x  # pub entries are already Ext values

    def ext_const(self, vec):
        return self.ops.ext_const(vec)

    def ext_powers(self, x, n: int):
        return ext_powers_w(self.ops, x, n)

    def einv(self, e):
        return self.ops.ext_inv(e)

    def bc(self, e, like):
        return e

    def B(self, s):
        # broadcast marker: an Ext here is itself a list, so (unlike
        # ProgAlg's int wires) scalars must be tagged to distinguish
        # them from groups in gmul/gadd
        return _Bcast(s)

    def gconst(self, vec):
        return [self.const(int(v)) for v in np.asarray(vec).tolist()]

    def _pairwise(self, op, x, y):
        if isinstance(x, _Bcast):
            return [op(x.e, b) for b in y]
        if isinstance(y, _Bcast):
            return [op(a, y.e) for a in x]
        assert len(x) == len(y)
        return [op(a, b) for a, b in zip(x, y)]

    def gmul(self, x, y):
        return self._pairwise(self.mul, x, y)

    def gadd(self, x, y):
        return self._pairwise(self.add, x, y)

    def gsub(self, x, y):
        return self._pairwise(self.sub, x, y)

    def gsum(self, x):
        acc = None
        for v in x:
            acc = v if acc is None else self.add(acc, v)
        return acc if acc is not None else self.zero()

    def gweighted_ext(self, x, w_ext):
        acc = None
        for v, w in zip(x, w_ext):
            t = self.mul(v, w)
            acc = t if acc is None else self.add(acc, t)
        return acc if acc is not None else self.zero()

    def gweighted(self, x, w_vec):
        acc = None
        for v, w in zip(x, np.asarray(w_vec).tolist()):
            w = int(w) % P
            if w == 0:
                continue
            t = [self.ops.scale(c, w) for c in v]
            acc = t if acc is None else self.add(acc, t)
        return acc if acc is not None else self.zero()

    def gconcat(self, groups):
        out = []
        for g in groups:
            out.extend(g)
        return out

    def gpub(self, vec):
        return list(vec)

    # ext aliases (the AIR uses both names)
    emul = mul
    eadd = add
    esub = sub
    eneg = neg

    def escale(self, e, s):
        return self.mul(e, s)


# ---------------------------------------------------------------------------
# The verifier circuit
# ---------------------------------------------------------------------------


def combine_constraints_r1cs(alg: R1csAlg, cons, alpha: Ext) -> Ext:
    sizes = [len(c.v) if isinstance(c, VecVal) else 1 for c in cons]
    apows = ext_powers_w(alg.ops, alpha, sum(sizes))
    acc = None
    k = 0
    for c in cons:
        vals = c.v if isinstance(c, VecVal) else [
            c.v if isinstance(c, ExtVal) else c]
        for v in vals:
            t = alg.mul(apows[k], v)
            acc = t if acc is None else alg.add(acc, t)
            k += 1
    return acc


def build_verifier(bld: Builder, air, po2: int, ps, control_id,
                   proof=None, pub_vals: Optional[Sequence[int]] = None):
    """Emit the full p254-suite STARK-verifier circuit.

    `proof`: a stark.SegmentProof (or None for layout mode). Public
    inputs (allocated by the caller as 3 felts) arrive via `pub_vals`
    (24 canonical scalars) — the circuit witnesses the unpacked elements
    and re-packs them against the public felts.
    """
    proof = _to_host(proof)
    ops = BBOps(bld)
    n = 1 << po2
    big = ps.commit_expand * n
    has_ctrl = air.ctrl_cols > 0
    has_accum = air.accum_cols > 0
    npub = 24

    # --- public felts + unpacked elements ---
    pv = (None if pub_vals is None
          else [int(x) for x in pub_vals])
    pub_felts = [bld.pub_var(None if pv is None else P254.pack_bb(
        pv[8 * i : 8 * i + 8])) for i in range(3)]
    bld.freeze_pub()
    pub_elems = [ops.wit_canonical(None if pv is None else pv[i])
                 for i in range(npub)]
    for i in range(3):
        repack = r1cs.pack_bb_felts(bld, ops, pub_elems[8 * i : 8 * i + 8])
        bld.enforce_zero(_lc_add(repack[0],
                                 _lc_scale(bld.lc(pub_felts[i]),
                                           r1cs.FR - 1)))

    def feed(x):
        return None if proof is None else _canon_arr(x)

    # --- transcript: pub binding ---
    tr = CircuitTranscript(bld, ops)
    tr.mix_bb_elems(pub_elems)

    def root_felt(words):
        if words is None:
            return bld.lc(bld.wit(None))
        return bld.lc(bld.wit(felt_of_words_const(words)))

    roots = {}
    if has_ctrl:
        # the control id is a compile-time constant — pins the program
        cid = bld.const_lc(P254.felt_of_words(
            [int(x) for x in control_id]))
        roots["ctrl"] = cid
        tr.mix_digest_felt(cid)
    roots["data"] = root_felt(None if proof is None
                              else np.asarray(proof.data_root))
    tr.mix_digest_felt(roots["data"])
    globals_ = [tr.sample_ext() for _ in range(air.globals_count)]
    if has_accum:
        roots["accum"] = root_felt(None if proof is None
                                   else np.asarray(proof.accum_root))
        tr.mix_digest_felt(roots["accum"])
    alpha = tr.sample_ext()
    roots["check"] = root_felt(None if proof is None
                               else np.asarray(proof.check_root))
    tr.mix_digest_felt(roots["check"])
    z = tr.sample_ext()

    # --- taps ---
    group_defs = []
    if has_ctrl:
        group_defs.append(("ctrl", air.ctrl_cols,
                           feed(proof.taps_ctrl) if proof is not None
                           else None))
    group_defs.append(("data", air.data_cols,
                       feed(proof.taps_data) if proof is not None
                       else None))
    if has_accum:
        group_defs.append(("accum", air.accum_cols,
                           feed(proof.taps_accum) if proof is not None
                           else None))
    taps: List[List[Ext]] = []
    for _name, cols, arr in group_defs:
        for cix in range(cols):
            taps.append([ext_read(ops, None if arr is None
                                  else arr[cix, pt]) for pt in range(2)])
    tc_arr = feed(proof.taps_check) if proof is not None else None
    # one EXT tap per check column (16 columns x 4 components)
    taps_check = [ext_read(ops, None if tc_arr is None else tc_arr[j])
                  for j in range(CHECK_COLS)]
    # flat mix exactly like stark.verify: per-group (col, pt, comp) order
    flat: List[BB] = []
    for col in taps:
        for pt in range(2):
            flat.extend(col[pt])
    for e in taps_check:
        flat.extend(e)
    tr.mix_bb_elems(flat)
    beta = tr.sample_ext()

    # --- DEEP points ---
    g_n = FBB.ROU_FWD[n.bit_length() - 1]
    zg = ext_scale_const(ops, z, g_n)
    z4 = ext_pow2k(ops, z, 2)

    # --- ALI at z ---
    alg = R1csAlg(ops)
    ct = sum(cols for _n_, cols, _a in group_defs)
    off = 0
    gtaps = []
    for _name, cols, _arr in group_defs:
        gtaps.append(taps[off : off + cols])
        off += cols
    gi = iter(gtaps)
    t_ctrl = next(gi) if has_ctrl else None
    t_data = next(gi)
    t_accum = next(gi) if has_accum else None
    now = _Cols(_Taps(t_ctrl, 0) if has_ctrl else None, _Taps(t_data, 0),
                _Taps(t_accum, 0) if has_accum else None)
    nxt = _Cols(_Taps(t_ctrl, 1) if has_ctrl else None, _Taps(t_data, 1),
                _Taps(t_accum, 1) if has_accum else None)
    # pub as flat ext values: pub[i] is a base scalar lifted to ext
    pub_ext = [[pub_elems[i], ops.const(0), ops.const(0), ops.const(0)]
               for i in range(npub)]
    cons = air.constraints(alg, now, nxt, globals_, pub_ext)
    combined = combine_constraints_r1cs(alg, cons, alpha)

    z_pow_n = ext_pow2k(ops, z, po2)
    zz = ext_add_base_const(ops, z_pow_n, P - 1)
    # Q(z) from check taps
    qs = []
    for i in range(CHECK_SPLIT):
        acc = None
        for c in range(4):
            e = alg._mul_basis(taps_check[i * 4 + c], c)
            acc = e if acc is None else ops.ext_add(acc, e)
        qs.append(acc)
    zpows = ext_powers_w(ops, z, CHECK_SPLIT)
    q_at_z = None
    for i in range(CHECK_SPLIT):
        t = ops.ext_mul(zpows[i], qs[i])
        q_at_z = t if q_at_z is None else ops.ext_add(q_at_z, t)
    ops.ext_assert_eq(combined, ops.ext_mul(zz, q_at_z))

    # --- FRI transcript phase ---
    rounds = fri.num_rounds(big, ps.fri_min_degree, ps.commit_expand)
    fri_roots = []
    fri_alphas = []
    for k in range(rounds):
        fr_ = root_felt(None if proof is None
                        else np.asarray(proof.fri_proof.round_roots[k]))
        fri_roots.append(fr_)
        tr.mix_digest_felt(fr_)
        fri_alphas.append(tr.sample_ext())
    final_m = big // (fri.FRI_FOLD ** rounds)
    final_deg = final_m // ps.commit_expand
    fc_arr = (feed(proof.fri_proof.final_coeffs)
              if proof is not None else None)
    final_coeffs = [ext_read(ops, None if fc_arr is None else fc_arr[d])
                    for d in range(final_deg)]
    tr.mix_bb_elems([c for e in final_coeffs for c in e])
    bits_total = big.bit_length() - 1
    qidx = [tr.sample_idx_bits(bits_total) for _ in range(ps.queries)]

    # --- FRI query phase ---
    inv16 = pow(fri.FRI_FOLD, P - 2, P)
    round0_vals = []
    for q in range(ps.queries):
        idx_bits = qidx[q]
        value = None
        cur_m, cur_shift = big, FBB.GENERATOR
        for k in range(rounds):
            rows_n = cur_m // fri.FRI_FOLD
            depth = rows_n.bit_length() - 1
            r_bits = idx_bits[:depth]
            t_bits = idx_bits[depth : depth + fri.FRI_FOLD_LOG]
            row_arr = (feed(proof.fri_proof.round_rows[k][q])
                       if proof is not None else None)
            row = [ext_read(ops, None if row_arr is None
                            else row_arr[4 * t : 4 * t + 4])
                   for t in range(fri.FRI_FOLD)]
            path_arr = (np.asarray(proof.fri_proof.round_paths[k][q])
                        if proof is not None else None)
            paths = [bld.lc(bld.wit(
                None if path_arr is None
                else felt_of_words_const(path_arr[d])))
                for d in range(depth)]
            leaf_elems = [c for e in row for c in e]
            merkle_check_felt(bld, ops, leaf_elems, r_bits,
                              fri_roots[k], paths)
            mine = mux_ext(bld, ops, row, t_bits)
            if value is None:
                round0_vals.append(mine)
            else:
                for c in range(4):
                    ops.assert_eq(BB(mine[c].lc, mine[c].bound), value[c])
            # fold with the direct formula
            w_inv = pow(FBB.ROU_FWD[cur_m.bit_length() - 1], P - 2, P)
            shift_inv = pow(cur_shift, P - 2, P)
            winv_r = exp_from_bits(ops, r_bits, w_inv)
            acc = None
            for t in range(fri.FRI_FOLD):
                c_t = shift_inv * pow(w_inv, t * rows_n, P) % P
                xinv_t = ops.scale(winv_r, c_t)
                ax = ext_scale_bb_of(ops, fri_alphas[k], xinv_t)
                s = ext_add_base_const(ops, ax, 1)
                pw = ax
                for _ in range(fri.FRI_FOLD_LOG - 1):
                    pw = ops.ext_mul(pw, pw)
                    s = ops.ext_add(s, ops.ext_mul(s, pw))
                term = ops.ext_mul(row[t], s)
                acc = term if acc is None else ops.ext_add(acc, term)
            value = ext_scale_const(ops, acc, inv16)
            idx_bits = r_bits
            cur_m = rows_n
            cur_shift = pow(cur_shift, fri.FRI_FOLD, P)
        # final polynomial evaluation at the surviving point
        w_fin = FBB.ROU_FWD[cur_m.bit_length() - 1]
        x_fin = ops.scale(exp_from_bits(ops, idx_bits, w_fin), cur_shift)
        acc = ops.ext_const([0, 0, 0, 0])
        for d in range(final_deg - 1, -1, -1):
            acc = ops.ext_add(ext_scale_bb_of(ops, acc, x_fin),
                              final_coeffs[d])
        for c in range(4):
            ops.assert_eq(acc[c], value[c])

    # --- committed-group openings + DEEP combo ---
    depth_c = big.bit_length() - 1
    betas = ext_powers_w(ops, beta, 2 * ct + CHECK_COLS)
    cp = []
    for cls, tap_list in ((0, [col[0] for col in taps]),
                          (1, [col[1] for col in taps]),
                          (2, None)):
        weights = (betas[:ct] if cls == 0 else
                   betas[ct : 2 * ct] if cls == 1 else betas[2 * ct :])
        if cls == 2:
            tap_list = taps_check
        acc = None
        for wgt, tw in zip(weights, tap_list):
            t = ops.ext_mul(wgt, tw)
            acc = t if acc is None else ops.ext_add(acc, t)
        cp.append(acc)

    order = []
    if has_ctrl:
        order.append(("ctrl", air.ctrl_cols, "open_ctrl"))
    order.append(("data", air.data_cols, "open_data"))
    if has_accum:
        order.append(("accum", air.accum_cols, "open_accum"))
    order.append(("check", CHECK_COLS, "open_check"))

    for q in range(ps.queries):
        idx_bits = qidx[q]
        opened = {}
        for name, cols, attr in order:
            opening = getattr(proof, attr) if proof is not None else None
            row_arr = (_canon_arr(opening.rows[q])
                       if opening is not None else None)
            row = [ops.wit_canonical(None if row_arr is None
                                     else int(row_arr[cix]))
                   for cix in range(cols)]
            path_arr = (np.asarray(opening.paths[q])
                        if opening is not None else None)
            paths = [bld.lc(bld.wit(
                None if path_arr is None
                else felt_of_words_const(path_arr[d])))
                for d in range(depth_c)]
            merkle_check_felt(bld, ops, row, idx_bits, roots[name], paths)
            opened[name] = row

        w_big = FBB.ROU_FWD[big.bit_length() - 1]
        x_q = ops.scale(exp_from_bits(ops, idx_bits, w_big),
                        FBB.GENERATOR)

        def col_sum(weights, rows_cols):
            acc = None
            j = 0
            for rowvals in rows_cols:
                for e in rowvals:
                    t = ext_scale_bb_of(ops, weights[j], e)
                    j += 1
                    acc = t if acc is None else ops.ext_add(acc, t)
            return acc

        trace_rows = [opened[name] for name, _c, _a in order[:-1]]
        s_z = col_sum(betas[:ct], trace_rows)
        s_zg = col_sum(betas[ct : 2 * ct], trace_rows)
        s_ch = col_sum(betas[2 * ct :], [opened["check"]])

        expected = None
        for cls, (s, point) in enumerate(((s_z, z), (s_zg, zg),
                                          (s_ch, z4))):
            den = ops.ext_sub([x_q, ops.const(0), ops.const(0),
                               ops.const(0)], point)
            inv_den = ops.ext_inv(den)
            num = ops.ext_sub(s, cp[cls])
            t = ops.ext_mul(num, inv_den)
            expected = t if expected is None else ops.ext_add(expected, t)
        for c in range(4):
            ops.assert_eq(expected[c], round0_vals[q][c])

    return pub_felts


def ext_scale_bb_of(ops: BBOps, e: Ext, s: BB) -> Ext:
    return [ops.mul(x, s) for x in e]
