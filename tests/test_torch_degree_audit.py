"""Constraint-degree auditor parity: the port (`boundless_tpu_torch/air/
degree.py`) against the JAX package on the CPU, on the same random words,
tolerance 0 (degrees are integers).

The reference's synthetic AIRs (`tests/test_degree_audit.py`): a power
constraint with a next-row term, and VecVal/ExtVal lanes; the overflow and
split-budget errors raised by both packages with the same messages;
RecursionAir at po2 5 against the JAX audit run here; rv32im, rv32i,
RecursionAir and KeccakAir against the JAX golden
`tests/data/torch_degree_golden.npz` (`make_torch_degree_golden.py`)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundless_tpu.air import degree as JDA
from boundless_tpu.air.dsl import Air as JAir
from boundless_tpu.core import field as JF
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu_torch.air import degree as DA
from boundless_tpu_torch.air.dsl import Air
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.recursion import air as rair
from boundless_tpu_torch.recursion import vm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_degree_golden.npz")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the audited cases and their publics)


def _pow_air(base, k: int):
    class _PowAir(base):
        """One constraint: c0^k, and a degree-2 cross term with the next
        row (the shifted view)."""

        name = "pow"
        data_cols = 2
        max_degree = 5

        def constraints(self, alg, now, nxt, globals_, pub):
            x = now.data[0]
            acc = x
            for _ in range(k - 1):
                acc = alg.mul(acc, x)
            trans = alg.mul(now.data[1], nxt.data[1])
            return [acc, trans]

    return _PowAir()


class _VecAir(Air):
    """VecVal + ExtVal lanes are audited per lane."""

    name = "vec"
    data_cols = 8
    globals_count = 1
    max_degree = 3

    def constraints(self, alg, now, nxt, globals_, pub):
        g = now.data.block(slice(0, 8))  # (M, 8)
        cube = alg.gmul(alg.gmul(g, g), g)
        e = F.ext_scale(globals_[0].expand(g.shape[:1] + (4,)), now.data[0])
        return [stark.VecVal(cube), stark.ExtVal(e)]


class _JVecAir(JAir):
    name = "vec"
    data_cols = 8
    globals_count = 1
    max_degree = 3

    def constraints(self, alg, now, nxt, globals_, pub):
        g = now.data.block(slice(0, 8))
        cube = alg.gmul(alg.gmul(g, g), g)
        e = JF.ext_scale(jnp.broadcast_to(globals_[0], g.shape[:1] + (4,)),
                         now.data[0])
        return [JSTARK.VecVal(cube), JSTARK.ExtVal(e)]


def _lanes(degs):
    return [(d.index, d.lane, d.kind, d.degree) for d in degs]


def _message(fn):
    with pytest.raises(AssertionError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_pow_air_degrees_equal_jax(k):
    po2, n = 4, 1 << 4
    degs = DA.audit_degrees(_pow_air(Air, k), pub=(), po2=po2, device="cpu")
    want = JDA.audit_degrees(_pow_air(JAir, k), pub=(), po2=po2)
    assert _lanes(degs) == _lanes(want)
    assert {d.index: d.degree for d in degs} == {0: k * (n - 1),
                                                 1: 2 * (n - 1)}
    assert degs[0].mult_degree(po2) == float(k)
    DA.assert_degrees(_pow_air(Air, k), pub=(), po2=po2, device="cpu")


def test_degree_overflow_message_equals_jax():
    # max_degree says 5 but the formula is degree 6: the bug class that
    # pointwise witness checks cannot see
    got = _message(lambda: DA.assert_degrees(_pow_air(Air, 6), pub=(),
                                             po2=4, device="cpu"))
    want = _message(lambda: JDA.assert_degrees(_pow_air(JAir, 6), pub=(),
                                               po2=4))
    assert "over degree budget" in got
    assert got == want


def test_split_budget_message_equals_jax():
    air, jair = _pow_air(Air, 9), _pow_air(JAir, 9)
    air.max_degree = jair.max_degree = 9  # only the hard budget trips
    got = _message(lambda: DA.assert_degrees(air, pub=(), po2=4,
                                             device="cpu"))
    want = _message(lambda: JDA.assert_degrees(jair, pub=(), po2=4))
    assert "EXCEEDS split budget" in got
    assert got == want


def test_vec_and_ext_lanes_equal_jax():
    po2, n = 4, 1 << 4
    degs = DA.audit_degrees(_VecAir(), pub=(), po2=po2, device="cpu")
    assert _lanes(degs) == _lanes(JDA.audit_degrees(_JVecAir(), pub=(),
                                                    po2=po2))
    vec = [d for d in degs if d.kind == "vec"]
    ext = [d for d in degs if d.kind == "ext"]
    assert len(vec) == 8 and all(d.degree == 3 * (n - 1) for d in vec)
    assert len(ext) == 4 and all(d.degree == n - 1 for d in ext)
    DA.assert_degrees(_VecAir(), pub=(), po2=po2, device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_recursion_air_equals_jax(seed):
    from boundless_tpu.recursion import air as jrair
    from boundless_tpu.recursion import vm as jvm

    degs = DA.assert_degrees(rair.AIR, rair.pub_array([0] * vm.PUB_VALS,
                                                      "cpu"),
                             po2=5, expand=16, seed=seed, device="cpu")
    want = JDA.assert_degrees(jrair.AIR, jrair.pub_array([0] * jvm.PUB_VALS),
                              po2=5, expand=16, seed=seed)
    assert _lanes(degs) == _lanes(want)
    assert max(d.degree for d in degs) <= 5 * ((1 << 5) - 1)


def _golden_case(name):
    """(AIR, publics) of the golden's case `name` on the CPU: the cases
    `chip_smoke.py` [audit] holds the card to."""
    return {n: (air, pub) for n, air, pub in
            chip_smoke.audit_cases(torch.device("cpu"))}[name]


@pytest.mark.parametrize("name", ["rv32im", "rv32i", "recursion", "keccak"])
def test_air_degrees_equal_jax_golden(name):
    g = np.load(GOLDEN)
    air, pub = _golden_case(name)
    degs = DA.assert_degrees(air, pub, po2=5, expand=16, device="cpu")
    assert [d.index for d in degs] == g[f"{name}/index"].tolist()
    assert [d.lane for d in degs] == g[f"{name}/lane"].tolist()
    assert [d.kind for d in degs] == g[f"{name}/kind"].tolist()
    assert [d.degree for d in degs] == g[f"{name}/degree"].tolist()
    if name != "recursion":
        # the AIR genuinely uses its budget: a degree-5 family
        assert max(d.degree for d in degs) == 5 * ((1 << 5) - 1)


def test_rv32im_point_class_budget():
    """rv32im is blinded: its point-class constraints are held to the
    split budget less the zk rows (the class list of the audit's own
    constraints() run)."""
    air, pub = _golden_case("rv32im")
    degs = DA.assert_degrees(air, pub, po2=5, device="cpu")
    zk = air.zk_rows(5)
    assert zk > 0 and len(air._zclass) == max(d.index for d in degs) + 1
    hard = DA.degree_budget(5)
    assert all(d.degree <= hard - zk for d in degs
               if not air._zclass[d.index])
