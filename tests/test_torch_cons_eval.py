"""Port parity: the traced constraint program behind the CUDA kernel.

1. The `EmitAlg` program, run node by node by a small torch interpreter,
   equals the eager `constraints` rows (`kernels/cons.evaluate_plain`) on a
   po2-6 4N grid, for both variants: the program is what the generated
   CUDA computes, one node per statement.
2. The port's plain fused combine (stacked rows, `alpha_weight_rows`,
   masked weighted sums) equals JAX `stark.combine_constraints` over the
   same constraint values, with and without the zk class masks (grid
   inputs as tests/test_pallas_cons.py builds them; that slow test holds
   the JAX combine equal to the Pallas kernel).
3. The generated CUDA text is deterministic, does not change with the
   publics, and every chunk (one device function of the one fused
   kernel) is within the op budget.
Exact equality throughout (field words)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.prover import stark as JSTARK
from boundless_tpu_torch.air import cons_eval as CE
from boundless_tpu_torch.air.dsl import BaseAlg, Columns
from boundless_tpu_torch.air.rv32im import Rv32imAir
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import cons as CK
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm import witness as W
from boundless_tpu_torch.zkvm.executor import Executor

PO2 = 6
VARIANTS = ["rv32i", "rv32im"]


def run_program(prog, ctrl, data, accum, pubvec):
    """Evaluate the SSA program over every row (the kernel's semantics:
    nxt is row r + 4 of the grid)."""
    m = data.shape[0]
    slots = []
    for e in (ctrl, data, accum):
        slots += [e, torch.roll(e, -4, 0)]
    vals = []
    for op, a, b in prog.nodes:
        if op == CE.COL:
            v = slots[a][:, b]
        elif op == CE.PUB:
            v = pubvec[a].expand(m)
        elif op == CE.LIT:
            v = torch.full((m,), a, dtype=F.I32)
        elif op == CE.ADD:
            v = F.add(vals[a], vals[b])
        elif op == CE.SUB:
            v = F.sub(vals[a], vals[b])
        elif op == CE.MUL:
            v = F.mul(vals[a], vals[b])
        else:
            v = F.neg(vals[a])
        vals.append(v)
    return torch.stack([vals[i] for i in prog.outputs])


@pytest.fixture(scope="module")
def grid():
    """The loop guest at po2 6 on the 4N grid, through the port (the
    inputs of tests/test_pallas_cons.py)."""
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


def other_publics(pub):
    """The same publics with the entry pc and one register changed."""
    other = type(pub)(**{k: v.clone() for k, v in vars(pub).items()})
    other.pre_pc.fill_(F.mont(0x2000))
    other.pre_regs[5] = F.mont(77)
    return other


@pytest.mark.parametrize("variant", VARIANTS)
def test_program_equals_eager_rows(grid, variant):
    """One program, two publics values: right for both (the program never
    depends on a public value)."""
    air, (ce, de, ae), globals_, pub = grid[variant]
    prog = CE.trace(air)
    for p in (pub, other_publics(pub)):
        want = CK.evaluate(air, ce, de, ae, globals_, p)  # CPU: plain
        assert want.shape == (CE.rows_of(prog.kinds), de.shape[0])
        assert tuple(prog.zclass) == tuple(air._zclass)
        got = run_program(prog, ce, de, ae, air.cons_pub_pack(p, globals_))
        assert torch.equal(got, want)
        assert bool((want != 0).any())


def test_fused_combine_equals_jax_combine_constraints(grid):
    """The same constraint values on the rv32i grid, α-combined by the
    port's fused route and by the JAX package's `combine_constraints`."""
    air, evals, globals_, pub = grid["rv32i"]
    acc = stark._ColAccessor
    cons = air.constraints(BaseAlg(), Columns(*(acc(e) for e in evals)),
                           Columns(*(acc(torch.roll(e, -4, 0))
                                     for e in evals)), globals_, pub)
    j = lambda x: jnp.asarray(x.numpy().astype(np.uint32))  # noqa: E731
    jcons = [JSTARK.VecVal(j(c.v)) if isinstance(c, stark.VecVal) else
             JSTARK.ExtVal(j(c.v)) if isinstance(c, stark.ExtVal) else j(c)
             for c in cons]
    alpha = F.ext(np.arange(4) + 7)
    rows = CK.evaluate(air, *evals, globals_, pub)
    kinds = CE.trace(air).kinds
    _, plan = stark._cons_plan(air, pub, PO2)
    masks = [None] + [keep for _, jobs in plan for keep, _ in jobs
                      if keep is not None]
    assert len(masks) > 1  # the zk classes split the items
    for mask, comb in zip(masks, CE.combine_rows(kinds, rows, alpha, masks)):
        want = JSTARK.combine_constraints(jcons, j(alpha), at_deep=False,
                                          keep=mask)
        np.testing.assert_array_equal(comb.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64))


def test_alpha_weights_follow_the_kinds():
    kinds = (("vec", 3), ("ext", 1), ("base", 1))
    alpha = F.ext([5, 6, 7, 8])
    w = CE.alpha_weight_rows(kinds, alpha)
    apows = NTT.ext_powers(alpha, 5)
    assert w.shape == (CE.rows_of(kinds), 4) == (8, 4)
    assert torch.equal(w[:3], apows[:3])
    assert torch.equal(w[3], apows[3])  # α^3 ⊗ X^0
    assert torch.equal(w[4], F.ext_mul(apows[3], F.ext([0, 1, 0, 0])))
    assert torch.equal(w[7], apows[4])


@pytest.mark.parametrize("variant", VARIANTS)
def test_generated_source_is_fixed_and_within_budget(grid, variant):
    """Two fresh traces print the same CUDA text; the publics enter only
    through the packed vector, whose words differ between two values."""
    _, _, globals_, pub = grid[variant]
    sources = []
    for _ in range(2):
        air = Rv32imAir(variant == "rv32im")  # fresh: no cached program
        sources.append(CK.cuda_source(CE.trace(air), air.name))
    assert sources[0] == sources[1]
    assert not torch.equal(air.cons_pub_pack(pub, globals_),
                           air.cons_pub_pack(other_publics(pub), globals_))
    prog = CE.trace(prove._AIRS[variant])
    parts = CK.chunks(prog)
    assert parts[0][0] == 0 and parts[-1][1] == len(prog.outputs)
    for (lo, hi, ids), nxt in zip(parts, parts[1:] + [None]):
        assert lo < hi and (nxt is None or nxt[0] == hi)
        assert sum(prog.nodes[i][0] in CE.ARITH for i in ids) <= CK.OP_BUDGET
    assert sources[0].count("__global__") == 1  # one fused kernel
    assert sources[0].count("__noinline__ Acc cons_") == len(parts)
    assert f"bt_cons_rows() {{ return {len(prog.outputs)}; }}" in sources[0]
