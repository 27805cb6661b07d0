"""Port parity: the fused constraint kernel's schedule and its α-combine.

1. A small interpreter of the generator's schedule (`kernels/cons.
   schedule`: the program's nodes in the emitted order, each output's four
   unreduced 64-bit products into its class accumulator, the folds, each
   warp's share of the chunks and the sum of the warps' accumulators, the
   final Montgomery reductions and the output selectors), in numpy with a
   check that no accumulator passes 2^64, equals the plain version
   `cons_eval.combine_rows(evaluate_plain(...))` on the po2-6 grid of
   tests/test_torch_cons_eval.py, for rv32i and rv32im, with the zk
   two-class masks and with one class; for rv32i also the JAX package's
   `stark.combine_constraints`.
2. The generated source is the same for two values of α and two publics,
   and holds no weight word: weights and publics are data of the launch.
3. The selectors follow the masks; a mask that splits a class raises.
Field words: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.prover import stark as JSTARK
from boundless_tpu_torch.air import cons_eval as CE
from boundless_tpu_torch.air.dsl import BaseAlg, Columns
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import cons as CK
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm import witness as W
from boundless_tpu_torch.zkvm.executor import Executor

PO2 = 6
VARIANTS = ["rv32i", "rv32im"]
P = F.P
U64 = np.uint64
LIMIT = (1 << 64) - 1


@pytest.fixture(scope="module")
def grid():
    """The loop guest at po2 6 on the 4N grid (tests/test_torch_cons_eval)."""
    image = guests.loop_guest()
    seg = Executor(image, guests.words([3]), segment_po2=PO2).run().segments[0]
    w = W.trace_segment(image, seg, PO2, rng=np.random.default_rng(1))
    globals_ = F.ext(np.stack([np.arange(4) + 3, np.arange(4) + 9]))
    out = {}
    for variant in VARIANTS:
        air = prove._AIRS[variant]
        data = F.fp(W.data_for_variant(w.data, variant))
        ctrl = F.fp(w.ctrl)
        accum = air.accum_trace(ctrl, data, globals_)
        ev = [NTT.coset_evaluate(NTT.interpolate(x), 4)
              for x in (ctrl, data, accum)]
        out[variant] = (air, ev, globals_, W.to_public_values(w.pub))
    return out


def run_schedule(prog, evals, pubvec, weights, sels):
    """The generated kernel's arithmetic, step by step, on every row."""
    m = evals[1].shape[0]
    slots = []
    for e in evals:
        slots += [e, torch.roll(e, -4, 0)]
    w = weights.numpy().astype(np.uint64)
    fold_c = U64((1 << 32) % P)
    vals = {}

    def value(i):
        op, a, _ = prog.nodes[i]
        return torch.full((m,), a, dtype=F.I32) if op == CE.LIT else vals[i]

    def fold(x):
        return (x >> U64(32)) * fold_c + (x & U64(LIMIT >> 32))

    parts = CK.schedule(prog, CK.OP_BUDGET)
    total = np.zeros((2 * F.EXT_DEGREE, m), dtype=np.uint64)
    for share in CK.warp_shares(parts, CK.WARPS):  # each warp's chunks
        acc = np.zeros((2 * F.EXT_DEGREE, m), dtype=np.uint64)
        for _, _, steps in (parts[i] for i in share):
            vals = {}  # no value lives across chunks
            for step in steps:
                if step[0] == "fold":
                    acc[step[1]] = fold(acc[step[1]])
                    continue
                if step[0] == "acc":
                    _, k, s = step
                    prod = (value(prog.outputs[k]).numpy().astype(np.uint64)
                            * w[k, s % 4])
                    assert np.all(acc[s] <= U64(LIMIT) - prod), "overflow"
                    acc[s] += prod
                    continue
                i = step[1]
                op, a, b = prog.nodes[i]
                if op == CE.COL:
                    vals[i] = slots[a][:, b]
                elif op == CE.PUB:
                    vals[i] = pubvec[a].expand(m)
                elif op == CE.ADD:
                    vals[i] = F.add(value(a), value(b))
                elif op == CE.SUB:
                    vals[i] = F.sub(value(a), value(b))
                elif op == CE.MUL:
                    vals[i] = F.mul(value(a), value(b))
                elif op == CE.NEG:
                    vals[i] = F.neg(value(a))
        assert np.all(acc < U64(1 << 60))  # folded at the end of a chunk
        total += acc  # the warps' sum through shared memory
    acc = fold(total)
    assert np.all(acc < U64(P) << U64(32))  # in range of one reduction
    red = [F._reduce(torch.from_numpy((acc[s] % U64(P)).astype(np.int64)))
           for s in range(2 * F.EXT_DEGREE)]
    out = []
    for sel in sels:
        cols = [torch.zeros(m, dtype=F.I32)] * 4
        for cls in (0, 1):
            if sel >> cls & 1:
                cols = [F.add(c, red[4 * cls + j])
                        for j, c in enumerate(cols)]
        out.append(torch.stack(cols, 1))
    return out


def class_masks(air, pub):
    """The fused route's keep-masks (stark._quotient_coeffs): one per
    divisor class, in its order."""
    kinds = CE.trace(air).kinds
    classes = {}
    for _, jobs in stark._cons_plan(air, pub, PO2)[1]:
        for keep, is_point in jobs:
            mask = classes.setdefault(is_point, [False] * len(kinds))
            for i in range(len(kinds)):
                mask[i] = mask[i] or keep is None or bool(keep[i])
    return [classes[p] for p in sorted(classes)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layout", ["two classes", "one class"])
def test_schedule_equals_plain_combine(grid, variant, layout):
    air, evals, globals_, pub = grid[variant]
    prog = CE.trace(air)
    masks = class_masks(air, pub) if layout == "two classes" else [None]
    assert len(masks) == (2 if layout == "two classes" else 1)
    alpha = F.ext(np.arange(4) + 7)
    want = CK.evaluate_combined(air, *evals, globals_, pub, alpha, masks)
    plain = CE.combine_rows(prog.kinds, CK.evaluate_plain(
        air, *evals, globals_, pub), alpha, masks)  # CPU: the same
    assert all(torch.equal(a, b) for a, b in zip(want, plain))
    got = run_schedule(prog, evals, air.cons_pub_pack(pub, globals_),
                       CE.alpha_weight_rows(prog.kinds, alpha),
                       CK.selectors(prog, masks))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (evals[1].shape[0], 4)
        assert torch.equal(g, w)
        assert bool((w != 0).any())


def test_schedule_equals_jax_combine_constraints(grid):
    air, evals, globals_, pub = grid["rv32i"]
    prog = CE.trace(air)
    acc = stark._ColAccessor
    cons = air.constraints(BaseAlg(), Columns(*(acc(e) for e in evals)),
                           Columns(*(acc(torch.roll(e, -4, 0))
                                     for e in evals)), globals_, pub)
    j = lambda x: jnp.asarray(x.numpy().astype(np.uint32))  # noqa: E731
    jcons = [JSTARK.VecVal(j(c.v)) if isinstance(c, stark.VecVal) else
             JSTARK.ExtVal(j(c.v)) if isinstance(c, stark.ExtVal) else j(c)
             for c in cons]
    alpha = F.ext(np.arange(4) + 11)
    masks = [None] + class_masks(air, pub)
    got = run_schedule(prog, evals, air.cons_pub_pack(pub, globals_),
                       CE.alpha_weight_rows(prog.kinds, alpha),
                       CK.selectors(prog, masks[:1]))
    got += run_schedule(prog, evals, air.cons_pub_pack(pub, globals_),
                        CE.alpha_weight_rows(prog.kinds, alpha),
                        CK.selectors(prog, masks[1:]))
    for mask, comb in zip(masks, got):
        want = JSTARK.combine_constraints(jcons, j(alpha), at_deep=False,
                                          keep=mask)
        np.testing.assert_array_equal(comb.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("variant", VARIANTS)
def test_source_is_independent_of_alpha_and_publics(grid, variant):
    air, _, globals_, pub = grid[variant]
    prog = CE.trace(air)
    other = type(pub)(**{k: v.clone() for k, v in vars(pub).items()})
    other.pre_pc.fill_(F.mont(0x2000))
    src = CK.cuda_source(prog, air.name)
    data_words = set()
    for alpha, p in ((F.ext([5, 6, 7, 8]), pub),
                     (F.ext([123456, 7, 99, 1 << 20]), other)):
        # the source is printed from the program alone: the same text
        # serves this α and these publics
        assert CK.cuda_source(CE.trace(air), air.name) == src
        data_words |= set(CE.alpha_weight_rows(prog.kinds, alpha)
                          .reshape(-1).tolist())
    literals = {int(x[:-1]) for x in src.replace("(", " ").replace(",", " ")
                .split() if x[:-1].isdigit() and x.endswith("u")}
    big = {x for x in data_words if F.unmont(x) > 1 << 20}
    assert len(big) > 100
    assert not big & literals


def test_selectors_follow_the_masks():
    prog = CE.trace(prove._AIRS["rv32i"])
    trans = [bool(z) for z in prog.zclass]
    assert any(trans) and not all(trans)
    point = [not z for z in trans]
    assert CK.selectors(prog, [None]) == [3]
    assert CK.selectors(prog, [trans, point]) == [1, 2]
    assert CK.selectors(prog, [point]) == [2]
    split = list(trans)
    split[trans.index(True)] = False
    with pytest.raises(ValueError):
        CK.selectors(prog, [split])
    counts = CK.combine_counts(prog)
    nonzero = [k for k in prog.outputs if prog.nodes[k] != (CE.LIT, 0, None)]
    assert counts["products"] == 4 * len(nonzero)
    assert counts["folds"] >= counts["products"] // (CK.FOLD_EVERY + 1)
    assert counts["reductions"] == 8
