"""The kernels' yardstick: the least time a launch's work can take on one
H100, counted from the launch's shapes, never from the kernel's code or
the card's clocks, so that no kernel change can move its own yardstick.

A launch's least time is the larger of its bytes at the card's memory
bandwidth and its field operations, as 32-bit instructions, at the card's
issue rate. Each input byte is read once and each output byte written
once. The operations are the algorithm's:

* a size-m NTT of one column: (m/2) log2 m butterflies, each one product
  and two sums; a multiplier table applied as the tile loads, stores or
  turns (the four-step's twiddles, a coset shift, a scale): one product
  an element it touches;
* a Poseidon2 permutation (width 24, 4 + 21 + 4 rounds, x^7 S-box):
  1,356 products and 2,352 sums (`P2_PRODUCTS`, `P2_SUMS`), and one sum
  for each word a sponge absorbs;
* one row of an AIR's constraints and their α-combination, counted on
  the benchmark's frozen copy of the AIR (`reference/rv32im.py`) by
  `cons_row_ops`: the work that depends on the row, each distinct
  operation once. An operation whose operands are the same for every
  row (literals, publics, the mix challenges) is done once and not per
  row; a product by a literal 0 or 1, a sum with a literal 0 and x - x
  are no work; a grouped operation counts once for each of its columns;
  and each of the K stacked constraint rows that depends on the row
  adds four products and four sums, its term in the (m, 4) combination.
  An ext product (x^4 = 11, schoolbook) is 16 products of coefficient
  pairs, 3 products by 11 (the wrapped terms of c0, c1, c2) and 12 sums
  (`EXT_MUL_PRODUCTS`, `EXT_MUL_SUMS`); an ext sum, difference or
  negation 4 sums; an ext value times a base value 4 products.

Constants (NVIDIA H100 SXM5 data sheet; the CUDA C++ Programming Guide's
throughput table for compute capability 9.0):
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .reference import dsl, rv32im
from .reference import field as F
from .reference.stark import ExtVal, VecVal

HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, 3.35 TB/s
SMS = 132  # streaming multiprocessors
BOOST_HZ = 1.98e9  # the largest boost clock, 1,980 MHz
# 4 warp schedulers an SM, each issuing one 32-lane instruction a clock:
# the most 32-bit instructions an SM can start a clock, of any kind
LANES_PER_SM_CLOCK = 128
ISSUE_PER_S = SMS * LANES_PER_SM_CLOCK * BOOST_HZ
# Baby Bear (p = 15 * 2^27 + 1) in Montgomery form on 32-bit words:
# a product is mul.lo, mul.hi, m = lo * p', mul.hi(m, p), a subtraction
# and one min-correction; a sum is an add (or sub) and one min-correction
INSTR_PER_PRODUCT = 6
INSTR_PER_SUM = 2

# Poseidon2 over Baby Bear, width 24: the external layer is six 4x4
# blocks of 14 sums, 20 sums of the blocks' totals and 24 of their
# broadcast (128); a full round adds 24 constants, 24 S-boxes of 4
# products and the external layer; a partial round adds one constant,
# one S-box, 24 products by the internal diagonal, 23 sums of the total
# and 24 of its broadcast; one external layer comes first.
P2_WIDTH, P2_RATE, P2_DIGEST = 24, 16, 8
P2_FULL, P2_PARTIAL = 8, 21
_EXT_SUMS = 6 * 14 + 20 + 24
P2_PRODUCTS = P2_FULL * 24 * 4 + P2_PARTIAL * (4 + 24)
P2_SUMS = _EXT_SUMS + P2_FULL * (24 + _EXT_SUMS) + P2_PARTIAL * (1 + 23 + 24)
WORD = 4  # bytes of a field word
# an ext product, schoolbook over x^4 = 11: 16 products of coefficient
# pairs, 3 by 11, and 3 sums a coefficient
EXT_MUL_PRODUCTS = 16 + 3
EXT_MUL_SUMS = 4 * 3


def least_seconds(instructions: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, instructions / ISSUE_PER_S)


def instructions(products: float, sums: float) -> float:
    return products * INSTR_PER_PRODUCT + sums * INSTR_PER_SUM


def ntt_work(rows_in: int, lanes: int, m: int, n2: int = 0,
             load: tuple = (0, 0), store: tuple = (0, 0),
             rows_out: int = 0) -> tuple:
    """(instructions, bytes) of one sub-transform launch: a size-m NTT of
    `lanes` columns whose first `rows_in` rows are read. `n2` > 0: the
    result turns through an (m, n2) twiddle table and every one of the
    m * lanes words is stored; else `rows_out` rows are stored. `load` /
    `store`: the (A, B) table lengths of a multiplier applied as the tile
    loads / stores (0, 0 when there is none)."""
    log_m = m.bit_length() - 1
    butterflies = (m // 2) * log_m * lanes
    products = butterflies
    out_words = m * lanes if n2 else rows_out * lanes
    table_words = m * n2
    if n2:
        products += m * lanes
    if load[0]:
        products += rows_in * lanes
        table_words += sum(load)
    if store[0]:
        products += out_words
        table_words += sum(store)
    nbytes = (rows_in * lanes + out_words + table_words) * WORD
    return instructions(products, 2 * butterflies), nbytes


def sponge_work(rows: int, cols: int, init: bool, out_words: int) -> tuple:
    """(instructions, bytes) of one sponge launch: each of `rows` rows of
    `cols` words absorbed at rate 16 (at least one permutation a row),
    from an initial state when `init`."""
    blocks = max(1, -(-cols // P2_RATE))
    perms = rows * blocks
    instr = instructions(perms * P2_PRODUCTS,
                         perms * P2_SUMS + rows * cols)
    nbytes = (rows * cols + (rows * P2_WIDTH if init else 0)
              + rows * out_words) * WORD
    return instr, nbytes


def tree_work(nodes: int) -> tuple:
    """(instructions, bytes) of a tree top over `nodes` digests: every
    level above them, nodes - 1 two-to-one hashes of one block each."""
    perms = nodes - 1
    instr = instructions(perms * P2_PRODUCTS,
                         perms * (P2_SUMS + 2 * P2_DIGEST))
    nbytes = (nodes + perms) * P2_DIGEST * WORD
    return instr, nbytes



# The constraint kernel. Its count runs the frozen AIR's `constraints`
# twice, on two rows of random words that share the publics and the mix
# challenges, and pairs the operands of each operation: a word that is
# the same in both runs does not depend on the row.

CONS_VARIANTS = ("rv32i", "rv32im")  # the frozen AIRs
CONS_PUB_WORDS = rv32im.Rv32imAir.PUB_VEC_WORDS  # the packed public vector
_BETA = F.mont(F.BETA)


class _Recorder(dsl.BaseAlg):
    """`BaseAlg` on one row that records the operand words of every
    operation, item by item: (kind, [(operand words, ...), ...], extra).
    A grouped operation has an item a column, an ext one four words an
    operand; a reduction one item of all its terms."""

    def __init__(self, s_pub):
        super().__init__("cpu")
        self.calls = []
        self.s_pub_const = s_pub  # S_pub comes in the packed public vector

    def _rec(self, kind, out, operands, per=1):
        words = [torch.broadcast_to(x, out.shape).reshape(-1, per).tolist()
                 for x in operands]
        self.calls.append((kind, list(zip(*words)), None))
        return out

    def add(self, a, b):
        return self._rec("add", F.add(a, b), (a, b))

    def sub(self, a, b):
        return self._rec("sub", F.sub(a, b), (a, b))

    def mul(self, a, b):
        return self._rec("mul", F.mul(a, b), (a, b))

    def neg(self, a):
        return self._rec("neg", F.neg(a), (a,))

    gadd, gsub, gmul = add, sub, mul

    def eadd(self, a, b):
        return self._rec("add", F.ext_add(a, b), (a, b), F.EXT_DEGREE)

    def esub(self, a, b):
        return self._rec("sub", F.ext_sub(a, b), (a, b), F.EXT_DEGREE)

    def eneg(self, a):
        return self._rec("neg", F.ext_neg(a), (a,), F.EXT_DEGREE)

    def emul(self, a, b):
        return self._rec("emul", F.ext_mul(a, b), (a, b), F.EXT_DEGREE)

    def escale(self, e, b):
        return self._rec("escale", F.ext_scale(e, b), (e, b[..., None]),
                         F.EXT_DEGREE)

    def ext_powers(self, x, n: int):
        self.calls.append(("powers", [(x.reshape(-1).tolist(),)], n))
        return super().ext_powers(x, n)

    def _reduce(self, kind, out, x, weights):
        items = [(row,) for row in x.reshape(-1, x.shape[-1]).tolist()]
        self.calls.append((kind, items, weights))
        return out

    def gsum(self, x):
        return self._reduce("sum", super().gsum(x), x, None)

    def gweighted(self, x, w_vec):
        # Σ x_g w_g on canonical weights: a Montgomery product by mont(w)
        w = F.mont_np(np.asarray(w_vec, dtype=np.int64) % F.P)
        return self._reduce("weighted", super().gweighted(x, w_vec), x,
                            [[int(v)] for v in w.reshape(-1)])

    def gweighted_ext(self, x, w_ext):
        return self._reduce("weighted", super().gweighted_ext(x, w_ext), x,
                            w_ext.tolist())

    def einv(self, e):
        raise ValueError("no count for an inversion in a row")


class _Tally:
    """Products and sums on pairs of words (run one, run two)."""

    def __init__(self):
        self.products = self.sums = 0
        self._seen = set()

    def op(self, kind, a, b=None) -> tuple:
        if kind == "neg":
            out = tuple((F.P - x) % F.P for x in a)
            if a[0] == a[1]:
                return out
            key = (kind, a)
        else:
            f = {"add": lambda x, y: (x + y) % F.P,
                 "sub": lambda x, y: (x - y) % F.P,
                 "mul": lambda x, y: x * y * F.R_INV % F.P}[kind]
            out = tuple(f(x, y) for x, y in zip(a, b))
            fixed = [w for w in (a, b) if w[0] == w[1]]
            if len(fixed) == 2 or (kind == "mul" and any(
                    w[0] in (0, F.ONE) for w in fixed)) or (
                    kind == "add" and any(w[0] == 0 for w in fixed)) or (
                    kind == "sub" and (a == b or b == (0, 0))):
                return out
            key = (kind,) + (tuple(sorted((a, b))) if kind != "sub"
                             else (a, b))
        if key not in self._seen:
            self._seen.add(key)
            if kind == "mul":
                self.products += 1
            else:
                self.sums += 1
        return out

    def total(self, terms) -> tuple:
        acc = None
        for t in terms:
            acc = t if acc is None else self.op("add", acc, t)
        return acc

    def emul(self, a, b) -> tuple:
        beta = (_BETA, _BETA)

        def m(x, y):
            return self.op("mul", x, y)

        s = self.total
        return (s([m(a[0], b[0]), m(beta, s([m(a[1], b[3]), m(a[2], b[2]),
                                             m(a[3], b[1])]))]),
                s([m(a[0], b[1]), m(a[1], b[0]),
                   m(beta, s([m(a[2], b[3]), m(a[3], b[2])]))]),
                s([m(a[0], b[2]), m(a[1], b[1]), m(a[2], b[0]),
                   m(beta, m(a[3], b[3]))]),
                s([m(a[0], b[3]), m(a[1], b[2]), m(a[2], b[1]),
                   m(a[3], b[0])]))

    def call(self, kind, operands, extra):
        """One recorded item; `operands` hold word pairs."""
        if kind in ("add", "sub", "mul", "neg"):
            for c in range(len(operands[0])):
                self.op(kind, *(o[c] for o in operands))
        elif kind == "escale":
            e, b = operands
            for c in range(F.EXT_DEGREE):
                self.op("mul", e[c], b[0])
        elif kind == "emul":
            self.emul(*operands)
        elif kind == "powers":
            p = ((F.ONE, F.ONE), (0, 0), (0, 0), (0, 0))
            for _ in range(extra - 1):
                p = self.emul(p, operands[0])
        elif kind == "sum":
            self.total(operands[0])
        else:  # weighted: per weight component, Σ_g x_g * w_g
            for c in range(len(extra[0])):
                self.total([self.op("mul", x, (w[c], w[c]))
                            for x, w in zip(operands[0], extra)])


class ConsRow(NamedTuple):
    products: int  # of one row's constraints
    sums: int
    rows: int  # K, the stacked constraint rows
    varying: int  # of them, those that depend on the row
    cols: tuple  # (ctrl, data, accum) columns


def _outputs(cons) -> list:
    """The K stacked constraint rows' words."""
    out = []
    for c in cons:
        v = c.v if isinstance(c, (VecVal, ExtVal)) else c
        out += v.reshape(-1).tolist()
    return out


def _words(gen: torch.Generator, *shape):
    return torch.randint(0, F.P, shape, generator=gen, dtype=F.I32)


class _Row:
    """One row of random words of a group's columns, as `constraints`
    reads it."""

    def __init__(self, gen: torch.Generator, cols: int):
        self.t = _words(gen, 1, cols)

    def __getitem__(self, i):
        return self.t[:, i]

    def block(self, idx):
        return self.t[:, idx if isinstance(idx, slice)
                      else torch.as_tensor(idx)]


def count_row(air, pub, gen: torch.Generator) -> ConsRow:
    """The count of one row of `air.constraints` (see the module's
    docstring) under the publics `pub`: two runs on rows of random words
    from `gen`, with the same publics, mix challenges and S_pub."""
    cols = (air.ctrl_cols, air.data_cols, air.accum_cols)
    globals_ = _words(gen, air.globals_count, F.EXT_DEGREE)
    s_pub = _words(gen, F.EXT_DEGREE)
    runs = []
    for _ in range(2):
        rec = _Recorder(s_pub)
        now, nxt = (dsl.Columns(*(_Row(gen, c) for c in cols))
                    for _ in range(2))
        cons = air.constraints(rec, now, nxt, globals_, pub)
        runs.append((rec.calls, _outputs(cons)))
    tally = _Tally()
    (calls_a, out_a), (calls_b, out_b) = runs
    for (kind, items_a, extra), (_, items_b, _) in zip(calls_a, calls_b):
        for item_a, item_b in zip(items_a, items_b):
            tally.call(kind, [tuple(zip(u, v)) for u, v in
                              zip(item_a, item_b)], extra)
    varying = sum(a != b for a, b in zip(out_a, out_b))
    return ConsRow(tally.products, tally.sums, len(out_a), varying, cols)


@functools.lru_cache(maxsize=None)
def cons_row_ops(variant: str) -> ConsRow:
    """The count of one row of the frozen `Rv32imAir(variant ==
    "rv32im")` constraints, on random publics."""
    if variant not in CONS_VARIANTS:
        raise ValueError(f"no constraint count for the AIR {variant!r}")
    gen = torch.Generator().manual_seed(0)
    w = functools.partial(_words, gen)
    pub = rv32im.PublicValues(
        pre_pc=w(), post_pc=w(), pre_regs=w(64), post_regs=w(64),
        halted=w(), pre_seqs=w(4), post_seqs=w(4), io=w(rv32im.IO_MAX, 5),
        cpio=w(rv32im.CP_IO, 4), mem=w(rv32im.MEM_PAGES,
                                       rv32im.MEM_PAGE_ELEMS))
    return count_row(rv32im.Rv32imAir(variant == "rv32im"), pub, gen)


def cons_work(variant: str, m: int, ctrl_cols: int, data_cols: int,
              accum_cols: int, outputs: int, classes: int) -> tuple:
    """(instructions, bytes) of one launch of the fused constraint kernel
    over an m-row grid of the AIR `variant`: each row's constraints and
    the α-combination of its `outputs` = K stacked rows into `classes`
    (m, 4) ext columns. Bytes: the three input grids read once, the
    packed public vector, the (K, 4) weights and the outputs written
    once. A layout other than the frozen AIR's raises."""
    row = cons_row_ops(variant)
    if (ctrl_cols, data_cols, accum_cols) != row.cols or outputs != row.rows:
        raise ValueError(
            f"{variant}: a launch of {(ctrl_cols, data_cols, accum_cols)} "
            f"columns and {outputs} rows; the frozen AIR has {row.cols}, "
            f"{row.rows}")
    ext = F.EXT_DEGREE
    instr = m * instructions(row.products + ext * row.varying,
                             row.sums + ext * row.varying)
    nbytes = (m * sum(row.cols) + CONS_PUB_WORDS + ext * outputs
              + classes * m * ext) * WORD
    return instr, nbytes
