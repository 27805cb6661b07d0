"""Lift-program parity and the recursion session on the CPU: the port
against the JAX package on the same inputs, tolerance 0.

The lift program verifies a segment STARK in-circuit: over the golden
po2-8 segment proofs of `tests/data/torch_golden_po2_8.npz`, the port's
witness stream (`serialize_proof` + claim witness) and its native data
trace equal the JAX package's, and the trace's sha256 is the one stored
in `torch_rec_golden.npz`; a proof with one word bumped makes both
evaluators raise. Then the per-segment pre-chains and a dev-mode session
(lift x3, join x2, finalize, verify) against JAX's `DevModeSystem`.

The `slow` cases prove for real on the CPU (lift -> join -> finalize at
segment po2 8, two queries, rec_po2 17) and hold the production programs'
ROMs (seg po2 17 `DEFAULT_PS` rv32i lift, rec_po2 20 q50 join/resolve) to
the JAX digests."""

import dataclasses
import hashlib
import os
import types

import numpy as np
import pytest

from boundless_tpu.recursion import succinct as JS
from boundless_tpu.recursion import vm as JVM
from boundless_tpu.zkvm import guests as JG
from boundless_tpu.zkvm import prove as JP
from boundless_tpu.zkvm import witness as JW
from boundless_tpu.zkvm.executor import Executor as JExecutor
from boundless_tpu_torch import convert
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.recursion import claims, programs, succinct, vm
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_rec_golden.npz")
PO2 = 8
LIFT_ROWS = 1 << 18
VARIANTS = ["rv32im", "rv32i"]
ECHO_SESSION = [50] + list(range(100, 150))  # three segments at po2 8


@pytest.fixture(scope="module")
def golden_maker():
    """`tests/data/make_torch_rec_golden.py` (its JAX readers of the
    golden segment proofs)."""
    import sys

    sys.path.insert(0, os.path.join(HERE, "data"))
    import make_torch_rec_golden

    return make_torch_rec_golden


def _port_segment(variant):
    """(canonical pub dict, port SegmentProof, pre_mem) of a golden proof."""
    g = np.load(os.path.join(HERE, "data", "torch_golden_po2_8.npz"))
    pre = variant + "/"
    proof = convert.proof_from_numpy({k[len(pre + "proof."):]: g[k]
                                      for k in g.files
                                      if k.startswith(pre + "proof.")})
    pub = {}
    for k in g.files:
        if k.startswith(pre + "in.pub."):
            v = F.from_mont(convert.tensor(g[k])).numpy().astype(np.int64)
            pub[k[len(pre + "in.pub."):]] = int(v) if v.ndim == 0 else v
    seg = Executor(guests.echo(), guests.words([2, 11, 22]),
                   segment_po2=PO2).run().segments[0]
    return pub, proof, seg.pre_mem


def _pub_vals(pub, proof, pre_mem):
    pre_root, post_root, _ = succinct.paging_walk(pub, pre_mem)
    image_id = F.from_mont(proof.ctrl_root).numpy()
    claim = claims.Claim.of_segment(image_id, pub, None, pre_root, post_root)
    return list(claim.digest()) + [0] * 16


@pytest.mark.parametrize("variant", VARIANTS)
def test_serialize_proof_equals_jax(variant, golden_maker):
    pub, proof, _ = _port_segment(variant)
    jpub, jproof, _ = golden_maker.golden_segment(variant)
    flat = succinct.rv_pub_flat(pub)
    assert flat == JS.rv_pub_flat(jpub)
    got = programs.serialize_proof(succinct.RV_AIRS[variant], proof, flat,
                                   PO2, prove.TEST_PS)
    want = JS.programs.serialize_proof(JS.RV_AIRS[variant], jproof, flat,
                                       PO2, JP.TEST_PS)
    assert len(got) == len(want)
    assert got == [tuple(int(x) for x in t) for t in want]


@pytest.mark.parametrize("variant", VARIANTS)
def test_lift_data_trace_equals_jax(variant, golden_maker):
    pub, proof, pre_mem = _port_segment(variant)
    jpub, jproof, _ = golden_maker.golden_segment(variant)
    prog = succinct.build_lift(PO2, prove.TEST_PS, variant).finalize(
        LIFT_ROWS)
    jprog = JS.build_lift(PO2, JP.TEST_PS, variant).finalize(LIFT_ROWS)
    wit = succinct.lift_witness(pub, proof, PO2, prove.TEST_PS, None,
                                pre_mem, variant, 0)
    jwit = JS.lift_witness(jpub, jproof, PO2, JP.TEST_PS, None, pre_mem,
                           variant, 0)
    assert wit == [tuple(int(x) for x in t) for t in jwit]
    pub_vals = _pub_vals(pub, proof, pre_mem)
    before = vm.NATIVE_EVALS
    data = vm.evaluate_native(prog, wit, pub_vals)
    assert vm.NATIVE_EVALS == before + 1
    np.testing.assert_array_equal(data, JVM.evaluate_native(jprog, jwit,
                                                            pub_vals))
    g = np.load(GOLDEN)
    assert golden_maker.words_sha256(data) == \
        str(g[f"lift/{variant}/data_sha256"])

    # one bumped proof word (a FRI final coefficient) makes the in-circuit
    # verifier's asserts fail in both packages
    fc = proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    bad = proof._replace(fri_proof=proof.fri_proof._replace(final_coeffs=fc))
    bad_wit = succinct.lift_witness(pub, bad, PO2, prove.TEST_PS, None,
                                    pre_mem, variant, 0)
    with pytest.raises(vm.EvalError):
        vm.evaluate_native(prog, bad_wit, pub_vals)
    with pytest.raises(JVM.EvalError):
        JVM.evaluate_native(jprog, bad_wit, pub_vals)


def _sessions():
    """The same three-segment echo session in both packages."""
    ex = Executor(guests.echo(), guests.words(ECHO_SESSION), segment_po2=PO2)
    res = ex.run()
    jex = JExecutor(JG.echo(), JG.words(ECHO_SESSION), segment_po2=PO2)
    jres = jex.run()
    assert len(res.segments) == len(jres.segments) == 3
    return ex, res, jex, jres


def test_segment_pre_chains_equal_jax():
    from boundless_tpu.cluster.agent import _segment_pre_chains

    ex, res, jex, jres = _sessions()
    got = succinct.segment_pre_chains(ex, res)
    want = _segment_pre_chains(jex, jres)
    assert got == {i: {int(t): tuple(v) for t, v in enc.items()}
                   for i, enc in want.items()}
    assert got[1][4] != claims.ZERO_CHAIN  # segment 0 committed words


def test_dev_mode_session_claims_equal_jax():
    ex, res, jex, jres = _sessions()
    image = guests.echo()
    chains = succinct.segment_pre_chains(ex, res)
    dev, jdev = succinct.DevModeSystem(), JS.DevModeSystem()
    lifts, jlifts = [], []
    for seg, jseg in zip(res.segments, jres.segments):
        r = prove.dev_receipt(image, seg, prove.TEST_PS, device="cpu")
        assert r.proof is None and r.variant == "rv32i"
        jpub = JW.trace_segment_native(JG.echo(), jseg, PO2).pub
        jr = types.SimpleNamespace(pub=jpub, image_id=r.image_id)
        lifts.append(dev.lift(r, chains[seg.index], seg.pre_mem, seg.index))
        jlifts.append(jdev.lift(jr, chains[seg.index], jseg.pre_mem,
                                jseg.index))
    j01, jj01 = dev.join(lifts[0], lifts[1]), jdev.join(jlifts[0], jlifts[1])
    root, jroot = dev.join(j01, lifts[2]), jdev.join(jj01, jlifts[2])
    for r, jr in zip(lifts + [j01, root], jlifts + [jj01, jroot]):
        assert r.claim.to_elems() == jr.claim.to_elems()
        assert r.pub_vals == jr.pub_vals
        assert dev.verify(r)
    words = [int(w) for w in ex.journal_words]
    assert words == ECHO_SESSION[1:]
    mem_root = succinct.paging.image_root(image)
    s = succinct.finalize_session(root, words, image.entry, mem_root)
    js = JS.finalize_session(jroot, words, image.entry, mem_root)
    assert s.journal == js.journal and s.image_id == js.image_id
    assert succinct.verify_session(s, dev)
    assert JS.verify_session(js, jdev)
    with pytest.raises(succinct.SuccinctError):
        succinct.finalize_session(root, words[:-1], image.entry, mem_root)
    bad = dataclasses.replace(root, claim=dataclasses.replace(
        root.claim, post_pc=root.claim.post_pc + 4))
    assert not dev.verify(bad)


# ---------------------------------------------------------------------------
# slow: real recursion proofs on the CPU, and the production ROMs
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_succinct_lift_join_session_cpu():
    """Segments -> lift STARKs -> join STARK -> session receipt, proved and
    verified by the port on the CPU at CI scale (not production
    soundness)."""
    ps = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
    params = succinct.SuccinctParams(seg_po2=PO2, seg_ps=ps, rec_po2=17,
                                     rec_ps=ps, variants=("rv32i",))
    system = succinct.SuccinctSystem(params, device="cpu")
    image = guests.echo()
    ex = Executor(image, guests.words([20] + ECHO_SESSION[1:21]),
                  segment_po2=PO2)
    res = ex.run()
    assert len(res.segments) == 2
    chains = succinct.segment_pre_chains(ex, res)
    lifts = []
    for seg in res.segments:
        sr = prove.prove_segment(image, seg, ps, device="cpu",
                                 rng=np.random.default_rng(seg.index))
        lifts.append(system.lift(sr, chains[seg.index], seg.pre_mem,
                                 seg.index))
        assert system.verify(lifts[-1])
    joined = system.join(*lifts)
    assert system.verify(joined) and joined.claim.halted
    words = [int(w) for w in ex.journal_words]
    session = succinct.finalize_session(joined, words, image.entry,
                                        succinct.paging.image_root(image))
    assert succinct.verify_session(session, system)
    fc = joined.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    bad = dataclasses.replace(joined, proof=joined.proof._replace(
        fri_proof=joined.proof.fri_proof._replace(final_coeffs=fc)))
    assert not system.verify(bad)
    bad = dataclasses.replace(joined, claim=dataclasses.replace(
        joined.claim, post_pc=1234))
    assert not system.verify(bad)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["lift_i", "join", "resolve"])
def test_production_rom_equals_jax_digest(kind):
    rec_ps = stark.ProofSystem(queries=50, fri_min_degree=256,
                               commit_expand=2)
    prog = {"lift_i": lambda: succinct.build_lift(17, prove.DEFAULT_PS,
                                                  "rv32i"),
            "join": lambda: succinct.build_join(20, rec_ps),
            "resolve": lambda: succinct.build_resolve(20, rec_ps)}[kind]()
    g = np.load(GOLDEN)
    assert len(prog.rows) == int(g[f"prod/{kind}/rows"])
    rom = prog.finalize(1 << 20).ctrl_trace_np()
    assert hashlib.sha256(rom.astype("<u4").tobytes()).hexdigest() == \
        str(g[f"prod/{kind}/rom_sha256"])
