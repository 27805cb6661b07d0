"""Port parity: executor, witness and the RV32IM AIR (both variants).

With BT_ZK_SEED set, the port's witness (Python replay and C++ loop), ctrl
trace and public values equal the JAX package's for the echo guest at
po2 8; the witness satisfies the port's AIR pointwise, and a tampered one
does not. Exact equality throughout."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.air import dsl as JDSL
from boundless_tpu.air import rv32im as JR
from boundless_tpu.core import field as JF
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu.zkvm import guests as jguests
from boundless_tpu.zkvm import witness as JW
from boundless_tpu.zkvm.executor import Executor as JExecutor
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import dsl
from boundless_tpu_torch.air import rv32im as R
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import guests
from boundless_tpu_torch.zkvm import witness as W
from boundless_tpu_torch.zkvm.executor import Executor

PO2 = 8
ZK_SEED = "777"
VARIANTS = ["rv32im", "rv32i"]
PAYLOAD = [3, 11, 22, 33]


def _echo_segment(executor_cls):
    """The echo segment, each package's objects built by its own guests
    module from the same assembly source and words."""
    g = guests if executor_cls is Executor else jguests
    res = executor_cls(g.echo(), g.words(PAYLOAD), segment_po2=PO2).run()
    assert len(res.segments) == 1
    return res


@pytest.fixture(scope="module")
def witnesses():
    """(port witness, JAX witness, port native witness) for echo, seeded."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BT_ZK_SEED", ZK_SEED)
    try:
        seg = _echo_segment(Executor).segments[0]
        jseg = _echo_segment(JExecutor).segments[0]
        out = (W.trace_segment(guests.echo(), seg, PO2),
               JW.trace_segment(jguests.echo(), jseg, PO2),
               W.trace_segment_native(guests.echo(), seg, PO2))
    finally:
        mp.undo()
    return out


def test_executor_matches_reference():
    res, jres = _echo_segment(Executor), _echo_segment(JExecutor)
    assert res.journal == jres.journal == guests.words(PAYLOAD[1:])
    s, js = res.segments[0], jres.segments[0]
    assert (s.cycles, s.pre_pc, s.reads, s.pre_seqs, s.touched_pages) == \
        (js.cycles, js.pre_pc, js.reads, js.pre_seqs, js.touched_pages)
    assert res.image_id == jres.image_id


def test_fast_execute_matches_reference():
    from boundless_tpu.zkvm.executor import fast_execute as j_fast_execute
    from boundless_tpu_torch.zkvm.executor import fast_execute

    assert fast_execute(guests.loop_guest(), guests.words([500])) == \
        j_fast_execute(jguests.loop_guest(), jguests.words([500]))
    assert vars(guests.loop_guest()) == vars(jguests.loop_guest())


@pytest.mark.parametrize("variant", VARIANTS)
def test_witness_matches_reference(witnesses, variant):
    w, jw, wn = witnesses
    for port in (w, wn):
        np.testing.assert_array_equal(
            W.data_for_variant(port.data, variant),
            JW.data_for_variant(jw.data, variant))
        np.testing.assert_array_equal(port.ctrl, jw.ctrl)
        assert sorted(port.pub) == sorted(jw.pub)
        for k in jw.pub:
            np.testing.assert_array_equal(port.pub[k], jw.pub[k])
    flat = convert.pub_to_numpy(W.to_public_values(w.pub))
    jflat = convert.pub_to_numpy(JW.to_public_values(jw.pub))
    assert sorted(flat) == sorted(jflat) == sorted(jw.pub)
    for k in jflat:
        np.testing.assert_array_equal(flat[k], jflat[k])
    back = convert.pub_to_numpy(convert.pub_from_numpy(jflat))
    for k in jflat:
        np.testing.assert_array_equal(back[k], jflat[k])


def test_explicit_rng_is_the_seeded_one(witnesses):
    seg = _echo_segment(Executor).segments[0]
    w = W.trace_segment(guests.echo(), seg, PO2,
                        rng=np.random.default_rng(int(ZK_SEED)))
    np.testing.assert_array_equal(w.data, witnesses[0].data)


def _globals(air):
    rng = np.random.default_rng(7)
    return F.ext(rng.integers(1, F.P, size=(air.globals_count, 4)))


def constraint_failures(air, w, variant):
    """Evaluate the port's AIR on the trace rows (next row cyclic);
    point-class families bind the real rows only. Returns the indices of
    constraints with a nonzero value."""
    data = F.fp(W.data_for_variant(w.data, variant))
    ctrl = F.fp(w.ctrl)
    pub = W.to_public_values(w.pub)
    globals_ = _globals(air)
    accum = air.accum_trace(ctrl, data, globals_)
    acc = stark._ColAccessor
    now = dsl.Columns(acc(ctrl), acc(data), acc(accum))
    nxt = dsl.Columns(*(acc(torch.roll(x, -1, 0)) for x in (ctrl, data, accum)))
    cons = air.constraints(dsl.BaseAlg(), now, nxt, globals_, pub)
    n, zk = data.shape[0], air.zk_rows(PO2)
    bad = []
    for i, (c, trans) in enumerate(zip(cons, air._zclass)):
        v = c.v if isinstance(c, (stark.ExtVal, stark.VecVal)) else c
        if not trans:
            v = v[: n - zk]
        if bool((v != 0).any()):
            bad.append(i)
    return bad


@pytest.mark.parametrize("variant", VARIANTS)
def test_witness_satisfies_air(witnesses, variant):
    air = R.Rv32imAir(variant == "rv32im")
    assert constraint_failures(air, witnesses[0], variant) == []


@pytest.mark.parametrize("variant", VARIANTS)
def test_tampered_witness_fails(witnesses, variant):
    air = R.Rv32imAir(variant == "rv32im")
    w = witnesses[0]
    data = w.data.copy()
    data[3, R.DC.rs1v.start] += 1  # a register read that disagrees
    bad = W.SegmentWitness(data=data, ctrl=w.ctrl, pub=w.pub)
    assert constraint_failures(air, bad, variant) != []


def test_muldiv_witness_satisfies_rv32im():
    res = Executor(guests.muldiv(), guests.words([1234567, 89]),
                   segment_po2=PO2).run()
    w = W.trace_segment(guests.muldiv(), res.segments[0], PO2)
    assert constraint_failures(R.Rv32imAir(True), w, "rv32im") == []


@pytest.mark.parametrize("variant", VARIANTS)
def test_accum_trace_and_public_sum_match(witnesses, variant):
    w, jw, _ = witnesses
    air, jair = R.Rv32imAir(variant == "rv32im"), JR.Rv32imAir(
        variant == "rv32im")
    g = _globals(air)
    data = W.data_for_variant(w.data, variant)
    got = air.accum_trace(F.fp(w.ctrl), F.fp(data), g)
    want = jair.accum_trace(JF.fp(jw.ctrl), JF.fp(data),
                            jnp.asarray(g.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = R.public_logup_sum(W.to_public_values(w.pub), g[0], g[1])
    js = JR.public_logup_sum(JW.to_public_values(jw.pub),
                             jnp.asarray(g[0].numpy().astype(np.uint32)),
                             jnp.asarray(g[1].numpy().astype(np.uint32)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("variant", VARIANTS)
def test_degrees_and_classes_match(witnesses, variant):
    air, jair = R.Rv32imAir(variant == "rv32im"), JR.Rv32imAir(
        variant == "rv32im")
    pub = W.to_public_values(witnesses[0].pub)
    jpub = JW.to_public_values(witnesses[1].pub)
    degs = dsl.constraint_degrees(air, pub)
    jdegs = JDSL.constraint_degrees(jair, jpub)
    assert len(degs) == len(jdegs)
    for d, jd in zip(degs, jdegs):
        np.testing.assert_array_equal(np.asarray(d), np.asarray(jd))
    assert air._zclass == jair._zclass
    for po2 in (8, 12, 17):
        assert stark._cons_plan(air, pub, po2) == \
            JSTARK._cons_plan(jair, jpub, po2)
