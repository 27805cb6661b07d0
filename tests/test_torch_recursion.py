"""Succinct recursion parity: the port (`boundless_tpu_torch/recursion/`)
against the JAX package on the CPU, on the same inputs, tolerance 0 (all
values are field words or digests).

Claims and paging on seeded random inputs; the ROMs of the CI-scale lift,
join and resolve programs word for word; the recursion VM's two
evaluators and the RecursionAir constraints and accumulator on the demo
program of `tests/test_recursion_air.py`; and a RecursionAir STARK proof
of that program at po2 8 (`TEST_PS`) equal to the JAX golden in
`tests/data/torch_rec_golden.npz` (`make_torch_rec_golden.py`)."""

import dataclasses
import inspect
import os
import sys

import numpy as np
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu.recursion import air as JAIR
from boundless_tpu.recursion import claims as JC
from boundless_tpu.recursion import succinct as JS
from boundless_tpu.recursion import vm as JVM
from boundless_tpu.zkvm import guests as JG
from boundless_tpu.zkvm import paging as JPG
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import dsl
from boundless_tpu_torch.air.rv32im import Rv32imAir
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.recursion import air as rair
from boundless_tpu_torch.recursion import claims, succinct, vm
from boundless_tpu_torch.zkvm import guests, paging, prove

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_recursion_air import _demo_pub  # noqa: E402  (the JAX demo)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_rec_golden.npz")
PO2 = 8
N = 1 << PO2
CI_PS = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
JCI_PS = JSTARK.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)


@pytest.fixture
def one_torch_thread():
    """torch's multi-threaded int64 kernels run slower in a process that
    has imported JAX; one thread keeps the proofs quick."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# claims
# ---------------------------------------------------------------------------


def _digest(rng):
    return tuple(int(x) for x in rng.integers(0, F.P, 8))


def _claim_fields(rng, **over):
    base = dict(
        image_id=_digest(rng), pre_pc=int(rng.integers(0, 1 << 20)),
        post_pc=int(rng.integers(0, 1 << 20)), halted=0,
        pre_regs=tuple(int(x) for x in rng.integers(0, 1 << 16, 64)),
        post_regs=tuple(int(x) for x in rng.integers(0, 1 << 16, 64)),
        pre_seqs=tuple(int(x) for x in rng.integers(0, 100, 4)),
        post_seqs=tuple(int(x) for x in rng.integers(100, 200, 4)),
        pre_journal=_digest(rng), post_journal=_digest(rng),
        pre_input=_digest(rng), post_input=_digest(rng),
        pre_assumptions=_digest(rng), post_assumptions=_digest(rng),
        pre_mem_root=_digest(rng), post_mem_root=_digest(rng),
        pre_coproc=_digest(rng), post_coproc=_digest(rng),
        pre_segments=int(rng.integers(0, 10)),
        post_segments=int(rng.integers(10, 20)))
    base.update(over)
    return base


def _both(fields):
    return claims.Claim(**fields), JC.Claim(**fields)


def test_claim_digests_equal():
    rng = np.random.default_rng(11)
    for _ in range(4):
        t, j = _both(_claim_fields(rng))
        assert t.to_elems() == j.to_elems()
        assert t.digest() == j.digest()
        assert t.digest_words() == j.digest_words()
        assert claims.digest_bytes(t.digest()) == JC.digest_bytes(j.digest())


def test_claim_join_and_resolve_equal():
    rng = np.random.default_rng(12)
    a = _claim_fields(rng)
    b = _claim_fields(rng, image_id=a["image_id"], pre_pc=a["post_pc"],
                      pre_regs=a["post_regs"], pre_seqs=a["post_seqs"],
                      pre_journal=a["post_journal"],
                      pre_input=a["post_input"],
                      pre_assumptions=a["post_assumptions"],
                      pre_mem_root=a["post_mem_root"],
                      pre_coproc=a["post_coproc"],
                      pre_segments=a["post_segments"], halted=1)
    (ta, ja), (tb, jb) = _both(a), _both(b)
    tj, jj = ta.join(tb), ja.join(jb)
    assert convert.claim_to_numpy(tj).keys() == convert.claim_to_numpy(jj).keys()
    for k, v in convert.claim_to_numpy(jj).items():
        np.testing.assert_array_equal(convert.claim_to_numpy(tj)[k], v, k)
    assert tj.digest() == jj.digest()
    with pytest.raises(AssertionError):
        tb.join(ta)
    # resolve: pop one assumption digest off a cons-list chain
    prev = _digest(rng)
    assumption = _digest(rng)
    post = claims.fold_words(prev, assumption)
    assert post == JC.fold_words(prev, assumption)
    tc, jc = _both(_claim_fields(rng, post_assumptions=post))
    assert tc.resolve(assumption, prev).digest() == \
        jc.resolve(assumption, prev).digest()
    assert claims.assumption_chain_prefixes(prev, [assumption, prev]) == \
        JC.assumption_chain_prefixes(prev, [assumption, prev])


def test_chain_folds_and_allowed_set_equal():
    rng = np.random.default_rng(13)
    pre = {t: _digest(rng) for t in claims.CHAIN_TAGS}
    io = np.zeros((12, 5), dtype=np.int64)
    for r in range(12):
        io[r] = (claims.CHAIN_TAGS[r % 3], r // 3, *rng.integers(0, 1 << 16, 2),
                 r % 4 != 3)
    assert claims.fold_io(pre, io) == JC.fold_io(pre, io)
    words = [int(x) for x in rng.integers(0, 1 << 32, 9)]
    assert claims.fold_words(pre[4], words) == JC.fold_words(pre[4], words)
    d = _digest(rng)
    assert claims.coproc_fold_step(pre[5], d) == JC.coproc_fold_step(pre[5], d)
    cpio = np.zeros((200, 4), dtype=np.int64)
    cpio[:100, 0] = np.arange(100)
    cpio[:100, 1:3] = rng.integers(0, 1 << 16, (100, 2))
    cpio[:100, 3] = 1
    assert claims.fold_coproc(pre[6], cpio) == JC.fold_coproc(pre[6], cpio)
    ids = [_digest(rng) for _ in range(3)]
    assert claims.allowed_set_root(ids) == JC.allowed_set_root(ids)
    for i in range(3):
        assert claims.allowed_set_path(ids, i) == JC.allowed_set_path(ids, i)


# ---------------------------------------------------------------------------
# paging
# ---------------------------------------------------------------------------


def test_paging_roots_and_walk_equal():
    rng = np.random.default_rng(14)
    words = {int(a): int(v) for a, v in zip(
        rng.integers(0, 1 << 20, 40), rng.integers(0, 1 << 32, 40))}
    t, j = paging.PageTree.from_words(words), JPG.PageTree.from_words(words)
    assert t.root() == j.root()
    for wa in list(words)[:3]:
        pg = wa // paging.PAGE_WORDS
        assert t.path(pg) == j.path(pg)
        assert paging.verify_path(pg, paging.page_hash(t.page_words(pg)),
                                  t.path(pg), t.root())
    t.set_word(5, 77)
    j.set_word(5, 77)
    assert t.root() == j.root()
    assert paging.image_root(guests.echo()) == JPG.image_root(JG.echo())
    assert prove.mem_root({4 * k: v for k, v in words.items()}) == \
        JPG.PageTree.from_words(words).root()


def test_paging_get_word_and_apply_updates_equal():
    rng = np.random.default_rng(15)
    words = {int(a): int(v) for a, v in zip(
        rng.integers(0, 1 << 16, 30), rng.integers(0, 1 << 32, 30))}
    t, j = paging.PageTree.from_words(words), JPG.PageTree.from_words(words)
    for wa in list(words)[:5] + [3, 1 << 20]:
        assert t.get_word(wa) == j.get_word(wa)
    updates = {int(p): [int(v) for v in rng.integers(0, 1 << 32, 64)]
               for p in rng.integers(0, 1 << 10, 3)} | {1 << 17: [0] * 64}
    assert paging.apply_updates(t, updates) == JPG.apply_updates(j, updates)
    assert t.root() == j.root()
    assert t.get_word(next(iter(updates)) * 64 + 7) == \
        updates[next(iter(updates))][7]


# ---------------------------------------------------------------------------
# programs: ROMs word for word
# ---------------------------------------------------------------------------


def test_verifier_pub_vals_equal_jax():
    from boundless_tpu.recursion import programs as JP
    from boundless_tpu_torch.recursion import programs

    rng = np.random.default_rng(16)
    pub = [int(x) for x in rng.integers(0, F.P, 45)]
    root = rng.integers(0, F.P, 8).astype(np.uint32)  # Montgomery words
    t_root = torch.from_numpy(root.astype(np.int32))
    for flat, jr, tr in ((pub, root, t_root), (pub, root, root),
                         (pub[:3], root ^ 2, torch.from_numpy(
                             (root ^ 2).astype(np.int32))),
                         (pub, None, None), ([], root, t_root)):
        want = JP.verifier_pub_vals(flat, jr)
        got = programs.verifier_pub_vals(flat, tr)
        assert got == [int(x) for x in want] and len(got) == 16


@pytest.mark.parametrize("variant", ["rv32im", "rv32i"])
def test_lift_rom_equals_jax(variant):
    t = succinct.build_lift(PO2, prove.TEST_PS, variant)
    j = JS.build_lift(PO2, JSTARK.ProofSystem(queries=8, fri_min_degree=16),
                      variant)
    assert t.name == j.name and t.n_inputs == j.n_inputs
    n = 1 << 18
    np.testing.assert_array_equal(t.finalize(n).ctrl_trace_np(),
                                  j.finalize(n).ctrl_trace_np())


@pytest.mark.parametrize("kind", ["join", "resolve"])
def test_join_and_resolve_roms_equal_jax(kind):
    t = getattr(succinct, f"build_{kind}")(17, CI_PS)
    j = getattr(JS, f"build_{kind}")(17, JCI_PS)
    assert t.n_inputs == j.n_inputs
    n = 1 << 17
    np.testing.assert_array_equal(t.finalize(n).ctrl_trace_np(),
                                  j.finalize(n).ctrl_trace_np())


# ---------------------------------------------------------------------------
# the demo program: evaluators, AIR, proof
# ---------------------------------------------------------------------------


def _port_demo():
    """The port's twin of `test_recursion_air._build_demo` (every op
    family), with the JAX demo's inputs and publics."""
    p = vm.Prog("demo")
    a = p.const((5, 0, 0, 0))
    b = p.input()
    c0 = p.mul(p.add(a, b), b)
    d = p.muladd(c0, c0, b)
    e = p.inv(d)
    p.assert_eq(p.mul(d, e), p.one())
    k = p.const((12345, 0, 0, 0))
    bits = p.decompose(k, 0, nbits=16)
    p.decompose(p.const((F.P - 1, 0, 0, 0)), 0, nbits=31)
    p.select(bits[0], d, c0)
    p.assert_eq(p.pub(0), d)
    h0, h1 = p.hash_packed([b], 4)
    p.assert_eq(p.pub(1), h0)
    p.assert_eq(p.pub(2), h1)
    p.t_init()
    p.t_mix_digest((h0, h1))
    chal = p.t_sample_ext()
    p.assert_eq(p.pub(3), chal)
    _, inputs, pub_vals = _demo_pub()
    return p.finalize(N), inputs, pub_vals


def test_demo_rom_and_evaluators_equal_jax():
    prog, inputs, pub_vals = _port_demo()
    jprog = _demo_pub()[0].finalize(N)
    np.testing.assert_array_equal(prog.ctrl_trace_np(), jprog.ctrl_trace_np())
    assert vm.perm_canonical(list(range(24))) == \
        JVM.perm_canonical(list(range(24)))
    before = vm.NATIVE_EVALS
    native = vm.evaluate_native(prog, inputs, pub_vals)
    assert vm.NATIVE_EVALS == before + 1
    plain = vm.evaluate(prog, inputs, pub_vals)
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, JVM.evaluate(jprog, inputs,
                                                       pub_vals))
    bad = [(pub_vals[0] + 1) % F.P] + list(pub_vals[1:])
    for evaluate in (vm.evaluate, vm.evaluate_native):
        with pytest.raises(vm.EvalError):
            evaluate(prog, inputs, bad)
    with pytest.raises(JVM.EvalError):
        JVM.evaluate(jprog, inputs, bad)
    assert vm.NATIVE_EVALS == before + 1  # a failed run is not counted


class _Cols:
    """Row accessor over a (M, C) trace for the JAX algebra."""

    def __init__(self, a):
        self._a = a

    def __getitem__(self, i):
        return self._a[:, i]

    def block(self, idx):
        if isinstance(idx, slice):
            return self._a[:, idx]
        return self._a[:, np.asarray(idx)]


def test_recursion_air_constraints_and_accum_equal_jax():
    import jax.numpy as jnp

    from boundless_tpu.air import dsl as JDSL

    prog, inputs, pub_vals = _port_demo()
    ctrl = rair.rom_trace(prog, N, "cpu")
    data = rair.data_trace(prog, inputs, pub_vals, "cpu")
    pub = rair.pub_array(pub_vals, "cpu")
    rng = np.random.default_rng(15)
    glob = rng.integers(0, F.P, (2, 4))
    accum = rair.AIR.accum_trace(ctrl, data, F.ext(glob))
    jctrl, jdata = jnp.asarray(ctrl.numpy().astype(np.uint32)), \
        jnp.asarray(data.numpy().astype(np.uint32))
    jglob = JF.fp(glob)
    jaccum = JAIR.AIR.accum_trace(jctrl, jdata, jglob)
    np.testing.assert_array_equal(accum.numpy().astype(np.uint32),
                                  np.asarray(jaccum))

    def cols(c, d, a, roll):
        return [x if not roll else np.roll(x, -1, 0) for x in (c, d, a)]

    tcons, jcons = [], []
    for roll in (False, True):
        t = [torch.from_numpy(x) for x in cols(ctrl.numpy(), data.numpy(),
                                               accum.numpy(), roll)]
        j = [jnp.asarray(x.astype(np.uint32)) for x in
             cols(ctrl.numpy(), data.numpy(), accum.numpy(), roll)]
        tcons.append(dsl.Columns(*(dsl.ColAccessor(x) for x in t)))
        jcons.append(JDSL.Columns(*(_Cols(x) for x in j)))
    tc = rair.AIR.constraints(dsl.BaseAlg(), tcons[0], tcons[1], F.ext(glob),
                              pub)
    jc = JAIR.AIR.constraints(JDSL.BaseAlg(), jcons[0], jcons[1], jglob,
                              JAIR.pub_array(pub_vals))
    def kinds(cons):
        return [getattr(type(c), "__name__") if hasattr(c, "v") else "base"
                for c in cons]

    assert kinds(tc) == kinds(jc)
    for i, (a, b) in enumerate(zip(tc, jc)):
        a = getattr(a, "v", a)
        b = getattr(b, "v", b)
        np.testing.assert_array_equal(a.numpy().astype(np.uint32),
                                      np.broadcast_to(np.asarray(b),
                                                      a.shape), f"item {i}")
        assert not a.any(), f"item {i} does not vanish on the demo trace"


def _golden_demo():
    g = np.load(GOLDEN)
    proof = {k[len("demo/proof."):]: g[k] for k in g.files
             if k.startswith("demo/proof.")}
    inputs = [tuple(int(x) for x in row) for row in g["demo/inputs"]]
    return g, inputs, [int(x) for x in g["demo/pub_vals"]], proof


def test_demo_recursion_proof_equals_jax_golden(one_torch_thread):
    g, inputs, pub_vals, gold = _golden_demo()
    prog, _, _ = _port_demo()
    ctrl = rair.rom_trace(prog, N, "cpu")
    data = rair.data_trace(prog, inputs, pub_vals, "cpu")
    np.testing.assert_array_equal(F.from_mont(ctrl).numpy(), g["demo/ctrl"])
    np.testing.assert_array_equal(F.from_mont(data).numpy(), g["demo/data"])
    pub = rair.pub_array(pub_vals, "cpu")
    proof = stark.prove(rair.AIR, data, pub, PO2, prove.TEST_PS, ctrl)
    flat = convert.proof_to_numpy(proof)
    assert sorted(flat) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(flat[k], gold[k], err_msg=k)
    root = stark.control_root_of(rair.AIR, PO2, ctrl, prove.TEST_PS)
    assert bool(stark.verify(rair.AIR, proof, pub, PO2, root, prove.TEST_PS))
    bad = rair.pub_array([(pub_vals[0] + 1) % F.P] + pub_vals[1:], "cpu")
    assert not bool(stark.verify(rair.AIR, proof, bad, PO2, root,
                                 prove.TEST_PS))

    # the receipt converters round-trip a recursion receipt
    claim = claims.Claim(**_claim_fields(np.random.default_rng(16)))
    r = succinct.RecReceipt(kind="join", proof=proof, claim=claim,
                            pub_vals=tuple(pub_vals), po2=PO2)
    back = convert.rec_receipt_from_numpy(convert.rec_receipt_to_numpy(r))
    assert (back.kind, back.claim, back.pub_vals, back.po2) == \
        (r.kind, r.claim, r.pub_vals, r.po2)
    for k, v in convert.proof_to_numpy(back.proof).items():
        np.testing.assert_array_equal(v, flat[k], k)


def test_fused_route_gates_on_the_air():
    """The generated constraint kernel serves only an AIR that declares it
    (rv32im, as the reference's `pallas_cons_ok`); RecursionAir's quotient
    takes the degree-split route on the card too. No card needed."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not stark._fused_route(rair.RecursionAir(), cuda)
    assert stark._fused_route(Rv32imAir(), cuda)
    assert stark._fused_route(Rv32imAir(False), cuda)
    assert not stark._fused_route(Rv32imAir(), cpu)


def test_recursion_entry_points_default_to_the_card():
    for fn in (stark.control_root_of, succinct.SuccinctSystem.__init__,
               succinct.get_system, prove.dev_receipt):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    params = succinct.SuccinctParams(seg_po2=PO2, seg_ps=CI_PS, rec_po2=17,
                                     rec_ps=CI_PS, variants=("rv32i",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        succinct.SuccinctSystem(params)
    assert hash(params) == hash(dataclasses.replace(params))
