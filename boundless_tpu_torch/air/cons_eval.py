"""Trace `Air.constraints` into a straight-line program for the CUDA kernel.

Counterpart of the algebra side of `boundless_tpu/air/pallas_eval.py`:
`TAlg` (:102), `_TAcc` (:262), `_cons_kinds` (:287), `_alpha_weight_rows`
(:333), `_kernel_body` (:361) and the α-combine tail of `combined_eval`
(:488-505). Where the TPU kernel ran `constraints` on in-VMEM tiles inside
the Pallas body, the port runs it once per AIR layout under `EmitAlg`, a
symbolic algebra with the whole surface of `dsl.BaseAlg`, and records an
SSA program of base-field operations on one row:

  * a base value is one node id, an extension value a 4-tuple of ids, a
    group of columns a list of ids;
  * column reads (`now` row r, `nxt` row r + INV_RATE of the 4N grid) and
    the words of the packed public vector (`air.cons_pub_pack`: globals,
    S_pub, boundary publics) are input nodes; numeric constants are
    literals, folded where both operands are known (exact field values);
  * identical operations are shared (hash-consing), so a column read or a
    product used by many constraints is one node.

`kernels/cons.py` prints the program as CUDA C. The program never sees a
public value (publics are input nodes, as the reference traced them), so
one compiled kernel serves every proof of an AIR layout. CUDA has no
counterpart of Pallas's "no captured constants" rule, so the TPU algebra's
collect/consume two-phase constant tables are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import bbmm
from ..core import field as F
from ..core import ntt as NTT
from .dsl import Columns, ExtVal, VecVal

# Node opcodes. A node is (op, a, b): inputs carry their location in a, b.
COL = "col"  # a = 2 * group + (1 if nxt), b = column; groups ctrl/data/accum
PUB = "pub"  # a = word of the packed public vector
LIT = "lit"  # a = Montgomery word
ADD, SUB, MUL, NEG = "add", "sub", "mul", "neg"
ARITH = (ADD, SUB, MUL, NEG)
GROUPS = ("ctrl", "data", "accum")


@dataclasses.dataclass(frozen=True)
class Program:
    """One row of the constraint DAG: `outputs[k]` is the node id of
    stacked constraint row k; `kinds` the reference's item list."""

    nodes: tuple  # (op, a, b) in creation (topological) order
    outputs: tuple  # K node ids
    kinds: tuple  # (("base"|"vec"|"ext", G), ...) per constraint item
    zclass: tuple  # per item: True = trans class (divides by Z_H)
    cols: tuple  # (ctrl_cols, data_cols, accum_cols)
    pub_words: int

    def live(self) -> list:
        """Node ids the outputs reach, ascending."""
        seen = set()
        stack = list(self.outputs)
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            op, a, b = self.nodes[i]
            if op in ARITH:
                stack.append(a)
                if b is not None:
                    stack.append(b)
        return sorted(seen)


def _mont_mul(a: int, b: int) -> int:
    return a * b * F.R_INV % F.P


class EmitAlg:
    """Symbolic `dsl.BaseAlg`: every operation appends SSA nodes."""

    is_ext = False

    def __init__(self):
        self.nodes = []
        self._memo = {}
        self.s_pub_const = None
        self._zero = self.lit(0)
        self._one = self.lit(F.ONE)

    # --- nodes ---
    def node(self, op, a, b=None) -> int:
        if op in (ADD, MUL) and a > b:
            a, b = b, a
        key = (op, a, b)
        idx = self._memo.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(key)
            self._memo[key] = idx
        return idx

    def lit(self, word: int) -> int:
        return self.node(LIT, int(word) % F.P)

    def _word(self, i: int):
        op, a, _ = self.nodes[i]
        return a if op == LIT else None

    # --- base ops (polymorphic over groups and ext tuples) ---
    def _map(self, f, a, b):
        if isinstance(a, list) or isinstance(b, list):
            a = a if isinstance(a, list) else [a] * len(b)
            b = b if isinstance(b, list) else [b] * len(a)
            assert len(a) == len(b), (len(a), len(b))
            return [f(x, y) for x, y in zip(a, b)]
        if isinstance(a, tuple) or isinstance(b, tuple):
            assert isinstance(a, tuple) and isinstance(b, tuple)
            return tuple(f(x, y) for x, y in zip(a, b))
        return f(a, b)

    def _add(self, a, b):
        wa, wb = self._word(a), self._word(b)
        if wa is not None and wb is not None:
            return self.lit(wa + wb)
        if wa == 0:
            return b
        if wb == 0:
            return a
        return self.node(ADD, a, b)

    def _sub(self, a, b):
        wa, wb = self._word(a), self._word(b)
        if wa is not None and wb is not None:
            return self.lit(wa - wb)
        if wb == 0:
            return a
        if a == b:
            return self._zero
        if wa == 0:
            return self.node(NEG, b)
        return self.node(SUB, a, b)

    def _mul(self, a, b):
        wa, wb = self._word(a), self._word(b)
        if wa is not None and wb is not None:
            return self.lit(_mont_mul(wa, wb))
        if wa == 0 or wb == 0:
            return self._zero
        if wa == F.ONE:
            return b
        if wb == F.ONE:
            return a
        return self.node(MUL, a, b)

    def _neg(self, a):
        w = self._word(a)
        return self.lit(-w) if w is not None else self.node(NEG, a)

    def add(self, a, b):
        return self._map(self._add, a, b)

    def sub(self, a, b):
        return self._map(self._sub, a, b)

    def mul(self, a, b):
        if isinstance(a, tuple) or isinstance(b, tuple):
            raise TypeError("base mul of an ext value (use emul/escale)")
        return self._map(self._mul, a, b)

    def neg(self, a):
        if isinstance(a, (list, tuple)):
            return type(a)(self._neg(x) for x in a)
        return self._neg(a)

    gmul, gadd, gsub = mul, add, sub

    def const(self, c: int):
        return self.lit(F.mont(int(c)))

    def one(self):
        return self._one

    def zero(self):
        return self._zero

    # --- ext ops: 4-tuples, x^4 = BETA ---
    def lift(self, b):
        return (b, self._zero, self._zero, self._zero)

    def emul(self, a, b):
        beta = self.const(F.BETA)
        m, add = self._mul, self._add
        a0, a1, a2, a3 = a
        b0, b1, b2, b3 = b
        return (
            add(m(a0, b0), m(beta, add(add(m(a1, b3), m(a2, b2)), m(a3, b1)))),
            add(add(m(a0, b1), m(a1, b0)), m(beta, add(m(a2, b3), m(a3, b2)))),
            add(add(m(a0, b2), add(m(a1, b1), m(a2, b0))), m(beta, m(a3, b3))),
            add(add(m(a0, b3), m(a1, b2)), add(m(a2, b1), m(a3, b0))))

    def eadd(self, a, b):
        return tuple(self._add(x, y) for x, y in zip(a, b))

    def esub(self, a, b):
        return tuple(self._sub(x, y) for x, y in zip(a, b))

    def eneg(self, a):
        return tuple(self._neg(x) for x in a)

    def escale(self, e, b):
        return tuple(self._mul(x, b) for x in e)

    def read_ext(self, accessor, base_idx: int):
        return tuple(accessor[base_idx + c] for c in range(4))

    def stack(self, items):
        return list(items)

    def pubval(self, x):
        return x

    def ext_const(self, vec):
        return tuple(self.const(v) for v in np.asarray(vec).ravel())

    def ext_powers(self, x, n: int):
        pows = [self.ext_const([1, 0, 0, 0])]
        for _ in range(n - 1):
            pows.append(self.emul(pows[-1], x))
        return pows

    def einv(self, e):
        raise NotImplementedError("no ext inversion in the constraint kernel")

    def bc(self, e, like):
        return e

    # --- groups: lists of ids ---
    def B(self, s):
        return s

    def gsize(self, group) -> int:
        return len(group)

    def gconst(self, vec):
        return [self.const(v) for v in np.asarray(vec).ravel()]

    def gsum(self, x):
        terms = list(x)
        if not terms:
            return self._zero
        while len(terms) > 1:  # balanced tree: short dependency chains
            nxt = [self._add(terms[i], terms[i + 1])
                   for i in range(0, len(terms) - 1, 2)]
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        return terms[0]

    def gweighted(self, x, w_vec):
        w = np.asarray(w_vec, dtype=np.int64).ravel()
        return self.gsum([self._mul(v, self.const(int(c)))
                          for v, c in zip(x, w)])

    def gweighted_ext(self, x, w_ext):
        return tuple(self.gsum([self._mul(v, w[c]) for v, w in zip(x, w_ext)])
                     for c in range(4))

    def gslice(self, x, a, b):
        return x[a:b]

    def gshift_sll(self, x, s):
        return [self._zero] * s + x[: len(x) - s] if s else x

    def gshift_srl(self, x, s):
        return x[s:] + [self._zero] * s if s else x

    def gshift_sra(self, x, s):
        return x[s:] + [x[-1]] * s if s else x

    def gconcat(self, groups):
        return [v for g in groups for v in g]

    def gpub(self, vec):
        return list(vec)


class _EmitCols:
    """Column accessor of one group and row (now / nxt) under EmitAlg."""

    def __init__(self, alg: EmitAlg, group: int, nxt: bool, ncols: int):
        self._alg, self._slot, self._n = alg, 2 * group + int(nxt), ncols

    def __getitem__(self, i):
        assert 0 <= i < self._n, (i, self._n)
        return self._alg.node(COL, self._slot, int(i))

    def block(self, idx):
        if isinstance(idx, slice):
            idx = range(idx.start, idx.stop)
        return [self[i] for i in idx]


def trace(air) -> Program:
    """The constraint program of `air` (cached per layout). The globals,
    S_pub and boundary publics are the words of the packed public vector
    (`air.cons_pub_unpack`), so one program serves every publics value."""
    cols = (air.ctrl_cols, air.data_cols, air.accum_cols)
    cache = air.__dict__.setdefault("_cons_programs", {})
    if cols not in cache:
        alg = EmitAlg()
        sm = [alg.node(PUB, w) for w in range(air.PUB_VEC_WORDS)]
        globals_list, kpub, s_pub = air.cons_pub_unpack(sm)
        alg.s_pub_const = s_pub
        now = Columns(*(_EmitCols(alg, g, False, c) for g, c in enumerate(cols)))
        nxt = Columns(*(_EmitCols(alg, g, True, c) for g, c in enumerate(cols)))
        cons = air.constraints(alg, now, nxt, globals_list, kpub)
        outputs, kinds = [], []
        for c in cons:
            if isinstance(c, VecVal):
                outputs.extend(c.v)
                kinds.append(("vec", len(c.v)))
            elif isinstance(c, ExtVal):
                outputs.extend(c.v)
                kinds.append(("ext", 1))
            else:
                outputs.append(c)
                kinds.append(("base", 1))
        cache[cols] = Program(tuple(alg.nodes), tuple(outputs), tuple(kinds),
                              tuple(air._zclass), cols, air.PUB_VEC_WORDS)
    return cache[cols]


def rows_of(kinds) -> int:
    """Stacked rows K: G per vec item, 4 per ext item, 1 per base item."""
    return sum(g if k == "vec" else (4 if k == "ext" else 1)
               for k, g in kinds)


@functools.lru_cache(maxsize=None)
def _weight_layout(kinds: tuple):
    """Per stacked row: the α-power it weighs with and the power c of the
    basis X^c it is multiplied by (numpy), and the number of powers."""
    power, comp, k = [], [], 0
    for kind, g in kinds:
        if kind == "ext":
            power += [k] * 4
            comp += range(4)
            k += 1
        else:
            power += range(k, k + g)
            comp += [0] * g
            k += g
    return np.array(power), np.array(comp), k


def alpha_weight_rows(kinds, alpha):
    """(K, 4) ext weights in the stacked row order, with the verifier's
    α-power assignment (`stark.combine_constraints`): an ext item's 4
    component rows weigh α^k ⊗ X^c (a base or vec row α^k ⊗ X^0).

    One word of α per proof: the powers and the basis products are
    computed on a CPU copy of α and the table is copied to α's device
    once (on the card, hundreds of tiny eager kernels cost milliseconds)."""
    power, comp, total = _weight_layout(tuple(kinds))
    pows = NTT.ext_powers(alpha.reshape(F.EXT_DEGREE).cpu(), total)
    basis = F.ext(np.eye(F.EXT_DEGREE, dtype=np.int64))
    w = F.ext_mul(pows[torch.from_numpy(power)], basis[torch.from_numpy(comp)])
    return w.to(alpha.device)


def combine_rows(kinds, rows, alpha, masks):
    """Σ_k α^k C_k over the stacked (K, M) constraint rows, once per item
    keep-mask (None keeps all) -> [(M, 4), ...]. One exact weighted sum
    serves every mask: a dropped item weighs zero, an exact no-op."""
    weights = alpha_weight_rows(kinds, alpha)
    cols = []
    for mask in masks:
        if mask is None:
            cols.append(weights)
            continue
        keep = [bool(k) for (kind, g), k in zip(kinds, mask)
                for _ in range(g if kind == "vec" else
                               (4 if kind == "ext" else 1))]
        sel = torch.tensor(keep, dtype=F.I32, device=weights.device)
        cols.append(weights * sel[:, None])
    sums = bbmm.bb_weighted_sum_t(rows, torch.cat(cols, 1))
    return list(sums.split(4, dim=1))
