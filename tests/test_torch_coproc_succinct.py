"""The succinct coproc lattice on the CPU: the port
(`recursion/coproc_succinct.py`, the coproc parts of `succinct.py`)
against the JAX package on the same inputs, tolerance 0.

CoprocClaim span semantics and the dev-mode lattice (mirroring
`tests/test_coproc_succinct.py`); `Claim.discharge_coproc`; the CI-scale
lift_keccak, union and resolve_coproc ROMs equal to the JAX ROMs of
`tests/data/torch_keccak_golden.npz` word for word; lift_keccak evaluated
by the native evaluator on the golden KeccakAir proof gives the JAX data
trace and is unsatisfiable for a bumped claim digest or a bumped public
limb; a dev-mode keccak-guest session finalizes only after
`resolve_coproc`.

The `slow` cases prove the whole chain for real on the CPU at CI scale
(keccak guest at seg po2 9, the smallest size its burst fits; coproc
lattice at rec_po2 19, main lattice at 17; two queries) and hold the production
programs' ROMs to the JAX digests."""

import dataclasses
import functools
import hashlib
import inspect
import os
import types

import numpy as np
import pytest
import torch

from boundless_tpu.recursion import claims as JC
from boundless_tpu.recursion import coproc_succinct as JCS
from boundless_tpu.recursion import succinct as JS
from boundless_tpu.zkvm import coproc as JCO
from boundless_tpu.zkvm import guests as JG
from boundless_tpu.zkvm import witness as JW
from boundless_tpu.zkvm.executor import Executor as JExecutor
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import keccak as K
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.recursion import claims
from boundless_tpu_torch.recursion import coproc_succinct as cs
from boundless_tpu_torch.recursion import succinct, vm
from boundless_tpu_torch.zkvm import coproc, guests, paging, prove
from boundless_tpu_torch.zkvm.executor import Executor

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_keccak_golden.npz")
KEC_PO2 = 7
CI_REC_PO2 = 19
CI_MAIN_REC_PO2 = 17  # the slow chain's main lattice (lift 114,264 rows)
CI_ROWS = 1 << CI_REC_PO2
GUEST_PO2 = 9  # the keccak burst does not fit a po2-8 segment
CI_PS = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
Q50 = stark.ProofSystem(queries=50, fri_min_degree=256, commit_expand=2)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 1 << 64, size=25,
                                          dtype=np.uint64)]
            for _ in range(n)]


def _dev_receipt(seed, n, po2=8):
    return coproc.prove_keccak(_states(seed, n), po2=po2, dev_mode=True)


def _golden_receipt(g) -> coproc.KeccakReceipt:
    flat = {"po2": np.array(KEC_PO2), "count": np.array(len(g["kec/states"])),
            "states_pub": g["kec/states_pub"]}
    flat.update({"proof." + k[len("kec/proof."):]: g[k] for k in g.files
                 if k.startswith("kec/proof.")})
    return convert.keccak_receipt_from_numpy(flat)


def _rom_of_diff(diff) -> np.ndarray:
    """The golden's transposed row differences -> (rows, cols) ROM."""
    return np.cumsum(np.asarray(diff, dtype=np.int64), axis=1).T


# ---------------------------------------------------------------------------
# claims
# ---------------------------------------------------------------------------


def test_claim_of_batch_matches_receipt_digests_and_jax():
    r = _dev_receipt(1, 3)
    cid = (1,) * 8
    c = cs.CoprocClaim.of_batch(cid, r.states_pub, r.count)
    h = claims.ZERO_CHAIN
    for k in range(r.count):
        h = cs.chain_step(h, cs.perm_digest_words(r.states_pub[k, 1:]))
    assert c.post_chain == h and c.pre_chain == claims.ZERO_CHAIN
    assert (c.pre_count, c.post_count) == (0, 3)
    d0 = cs.perm_digest_words(r.states_pub[0, 1:])
    assert r.digests()[0] == b"".join(
        int(w).to_bytes(4, "little") for w in d0)
    jc = JCS.CoprocClaim.of_batch(cid, r.states_pub, r.count)
    assert c.to_elems() == jc.to_elems() and c.digest() == jc.digest()
    assert cs.chain_step(h, d0) == JCS.chain_step(h, d0)


def test_coproc_receipt_claim_digest_equals_jax():
    r = _dev_receipt(4, 2)
    args = dict(kind="lift_keccak", proof=None, pub_vals=(), po2=8)
    got = cs.CoprocRecReceipt(claim=cs.CoprocClaim.of_batch(
        (3,) * 8, r.states_pub, r.count), **args).claim_digest()
    want = JCS.CoprocRecReceipt(claim=JCS.CoprocClaim.of_batch(
        (3,) * 8, r.states_pub, r.count), **args).claim_digest()
    assert got == want and len(got) == 8


def test_claim_union_spans_and_rejects_discontinuity():
    r1, r2 = _dev_receipt(2, 2), _dev_receipt(3, 2)
    cid = (7,) * 8
    c1 = cs.CoprocClaim.of_batch(cid, r1.states_pub, r1.count)
    c2 = cs.CoprocClaim.of_batch(cid, r2.states_pub, r2.count,
                                 pre_chain=c1.post_chain, pre_count=2)
    u = c1.union(c2)
    assert u.pre_chain == claims.ZERO_CHAIN
    assert u.post_chain == c2.post_chain
    assert (u.pre_count, u.post_count) == (0, 4)
    with pytest.raises(ValueError):
        c2.union(c1)  # wrong order: chains don't meet
    c3 = cs.CoprocClaim.of_batch((8,) * 8, r2.states_pub, r2.count,
                                 pre_chain=c1.post_chain, pre_count=2)
    with pytest.raises(ValueError):
        c1.union(c3)  # circuit id mismatch
    j1 = JCS.CoprocClaim.of_batch(cid, r1.states_pub, r1.count)
    j2 = JCS.CoprocClaim.of_batch(cid, r2.states_pub, r2.count,
                                  pre_chain=j1.post_chain, pre_count=2)
    assert u.digest() == j1.union(j2).digest()


def test_devmode_lattice_equals_jax():
    dev, jdev = cs.DevModeCoprocSystem(), JCS.DevModeCoprocSystem()
    r1, r2 = _dev_receipt(4, 2), _dev_receipt(5, 1)
    l1, jl1 = dev.lift(r1), jdev.lift(r1)
    l2 = dev.lift(r2, pre_chain=l1.claim.post_chain,
                  pre_count=l1.claim.post_count)
    jl2 = jdev.lift(r2, pre_chain=jl1.claim.post_chain,
                    pre_count=jl1.claim.post_count)
    u, ju = dev.union(l1, l2), jdev.union(jl1, jl2)
    assert dev.verify(u) and u.claim.post_count == 3
    assert u.claim.digest() == cs.CoprocClaim(
        l1.claim.circuit_id, l1.claim.pre_chain, l2.claim.post_chain,
        0, 3).digest()
    for r, jr in ((l1, jl1), (l2, jl2), (u, ju)):
        assert r.pub_vals == jr.pub_vals and r.kind == jr.kind
        back = convert.coproc_rec_receipt_from_numpy(
            convert.rec_receipt_to_numpy(jr))
        assert back.claim == r.claim and back.pub_vals == r.pub_vals
        assert back.proof is None


def _seg_claims(cp_pre, cp_post, seqs_span):
    """A port Claim and a JAX Claim with the given coproc span."""
    fields = dict(image_id=(1,) * 8, pre_pc=4096, post_pc=4200, halted=1,
                  pre_regs=(0,) * 64, post_regs=(3,) * 64,
                  pre_seqs=(0, 0, 0, 0), post_seqs=(2, 0, 0, seqs_span),
                  pre_journal=(0,) * 8, post_journal=(5,) * 8,
                  pre_input=(0,) * 8, post_input=(0,) * 8,
                  pre_assumptions=(0,) * 8, post_assumptions=(0,) * 8,
                  pre_coproc=cp_pre, post_coproc=cp_post)
    return claims.Claim(**fields), JC.Claim(**fields)


def test_discharge_coproc_equals_jax():
    r = _dev_receipt(6, 2)
    span = cs.CoprocClaim.of_batch((9,) * 8, r.states_pub, r.count)
    jspan = JCS.CoprocClaim.of_batch((9,) * 8, r.states_pub, r.count)
    c, jc = _seg_claims(claims.ZERO_CHAIN, span.post_chain, 200)
    got, want = c.discharge_coproc(span), jc.discharge_coproc(jspan)
    assert got.to_elems() == want.to_elems()
    assert got.post_coproc == claims.ZERO_CHAIN and got.digest() != c.digest()
    for bad_c, bad_j in (_seg_claims(claims.ZERO_CHAIN, span.post_chain, 100),
                         _seg_claims((1,) * 8, span.post_chain, 200),
                         _seg_claims(claims.ZERO_CHAIN, (1,) * 8, 200)):
        with pytest.raises(ValueError):
            bad_c.discharge_coproc(span)
        with pytest.raises(ValueError):
            bad_j.discharge_coproc(jspan)


# ---------------------------------------------------------------------------
# programs: CI-scale ROMs and the lift_keccak data trace
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ci_prog(kind, root, cid) -> vm.Prog:
    make = {
        "lift_keccak": lambda: cs.build_lift_keccak(KEC_PO2, CI_PS),
        "union": lambda: cs.build_union(CI_REC_PO2, CI_PS),
        "resolve_coproc": lambda: succinct.build_resolve_coproc(
            CI_REC_PO2, CI_PS, root, CI_REC_PO2, CI_PS, cid)}[kind]
    return make().finalize(CI_ROWS)


def _placeholders(g):
    return (tuple(int(x) for x in g["placeholder/coproc_root"]),
            tuple(int(x) for x in g["placeholder/kec_circuit_id"]))


@pytest.mark.parametrize("kind", ["lift_keccak", "union", "resolve_coproc"])
def test_ci_rom_equals_jax(kind, golden):
    prog = _ci_prog(kind, *_placeholders(golden))
    assert len(prog.rows) == CI_ROWS
    want = _rom_of_diff(golden[f"ci/{kind}/rom_diff"])
    np.testing.assert_array_equal(prog.ctrl_trace_np().astype(np.int64),
                                  want)


def test_lift_keccak_accepts_the_golden_proof_and_rejects_tampers(golden):
    r = _golden_receipt(golden)
    prog = _ci_prog("lift_keccak", *_placeholders(golden))
    cid = tuple(int(x) for x in golden["kec/circuit_id"])
    wit = cs.lift_witness(r, KEC_PO2, CI_PS)
    claim = cs.CoprocClaim.of_batch(cid, r.states_pub, r.count)
    assert claim.post_count == 2
    pub_vals = tuple(list(claim.digest()) + [0] * 16)
    before = vm.NATIVE_EVALS
    data = vm.evaluate_native(prog, wit, pub_vals)
    assert vm.NATIVE_EVALS == before + 1
    digest = hashlib.sha256(np.ascontiguousarray(
        data.astype("<u4")).tobytes()).hexdigest()
    assert digest == str(golden["kec/lift_data_sha256"])
    # a claim digest that is not the derived one is unsatisfiable
    bad = tuple([(claim.digest()[0] + 1) % cs.P] + list(claim.digest()[1:])
                + [0] * 16)
    with pytest.raises(vm.EvalError):
        vm.evaluate_native(prog, wit, bad)
    # one public state limb bumped: the in-circuit verifier fails
    r2 = dataclasses.replace(r, states_pub=np.array(r.states_pub))
    r2.states_pub[0, 5] = (int(r2.states_pub[0, 5]) + 1) % cs.P
    claim2 = cs.CoprocClaim.of_batch(cid, r2.states_pub, r2.count)
    with pytest.raises(vm.EvalError):
        vm.evaluate_native(prog, cs.lift_witness(r2, KEC_PO2, CI_PS),
                           tuple(list(claim2.digest()) + [0] * 16))


def test_lift_keccak_without_a_fri_round_raises_as_jax():
    """At kec_po2 8 with fri_min_degree 256 the keccak proof has no FRI
    fold round, and the reference's in-circuit verifier indexes an empty
    list of round-0 values: the port raises the same way."""
    from boundless_tpu.prover import stark as JSTARK

    with pytest.raises(IndexError):
        JCS.build_lift_keccak(8, JSTARK.ProofSystem(queries=1,
                                                    fri_min_degree=256))
    with pytest.raises(IndexError):
        cs.build_lift_keccak(8, stark.ProofSystem(queries=1,
                                                  fri_min_degree=256))


# ---------------------------------------------------------------------------
# a dev-mode keccak-guest session
# ---------------------------------------------------------------------------


def _coproc_lifts(system, ex, kec_po2, **kw):
    """Batch the session's permutations by max_perms(kec_po2), chained
    (the cluster's coprocessor stream), and lift each batch."""
    batch = K.max_perms(kec_po2)
    lifts, chain, count = [], claims.ZERO_CHAIN, 0
    for b in range(0, len(ex.keccak_states), batch):
        states = ex.keccak_states[b: b + batch]
        r = coproc.prove_keccak(states, kec_po2, **kw)
        lifts.append((r, system.lift(r, chain, count)))
        chain, count = lifts[-1][1].claim.post_chain, count + len(states)
    return lifts


def test_dev_mode_keccak_session_finalizes_after_resolve_coproc():
    image = guests.keccak_guest()
    ex = Executor(image, guests.words([]), segment_po2=GUEST_PO2)
    res = ex.run()
    assert len(res.segments) == 1 and len(ex.keccak_states) == 1
    seg = res.segments[0]
    chains = succinct.segment_pre_chains(ex, res)
    sr = prove.dev_receipt(image, seg, prove.TEST_PS, device="cpu")
    assert sr.variant == "rv32im"
    dev = succinct.DevModeSystem()
    lift = dev.lift(sr, chains[seg.index], seg.pre_mem, seg.index)
    assert lift.claim.post_coproc != claims.ZERO_CHAIN
    words = [int(w) for w in ex.journal_words]
    mem_root = paging.image_root(image)
    with pytest.raises(succinct.SuccinctError, match="coproc"):
        succinct.finalize_session(lift, words, image.entry, mem_root)

    ((kr, clift),) = _coproc_lifts(cs.DevModeCoprocSystem(), ex, 8,
                                   dev_mode=True)
    assert kr.digests() == list(ex.keccak_claims)
    resolved = dev.resolve_coproc(lift, clift)
    assert resolved.claim.post_coproc == claims.ZERO_CHAIN
    assert dev.verify(resolved)
    session = succinct.finalize_session(resolved, words, image.entry,
                                        mem_root)
    assert succinct.verify_session(session, dev)
    with pytest.raises(ValueError):  # a span that is not the guest's
        dev.resolve_coproc(lift, cs.DevModeCoprocSystem().lift(
            _dev_receipt(7, 1)))

    # the JAX package derives the same claims
    jex = JExecutor(JG.keccak_guest(), JG.words([]), segment_po2=GUEST_PO2)
    jseg = jex.run().segments[0]
    jpub = JW.trace_segment_native(JG.keccak_guest(), jseg, GUEST_PO2).pub
    jdev = JS.DevModeSystem()
    jlift = jdev.lift(types.SimpleNamespace(pub=jpub, image_id=sr.image_id),
                      chains[seg.index], jseg.pre_mem, jseg.index)
    jclift = JCS.DevModeCoprocSystem().lift(
        JCO.prove_keccak(jex.keccak_states, 8, dev_mode=True))
    jres = jdev.resolve_coproc(jlift, jclift)
    assert lift.claim.to_elems() == jlift.claim.to_elems()
    assert resolved.claim.to_elems() == jres.claim.to_elems()
    assert resolved.pub_vals == jres.pub_vals


def test_coproc_entry_points_default_to_the_card():
    for fn in (cs.CoprocSystem.__init__, cs.get_system,
               succinct.SuccinctSystem.__init__, succinct.get_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cparams = cs.CoprocParams(kec_po2=KEC_PO2, kec_ps=CI_PS,
                              rec_po2=CI_REC_PO2, rec_ps=CI_PS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.CoprocSystem(cparams)
    params = succinct.SuccinctParams(seg_po2=GUEST_PO2, seg_ps=CI_PS,
                                     rec_po2=CI_REC_PO2, rec_ps=CI_PS,
                                     variants=("rv32im",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        succinct.SuccinctSystem(params, coproc=cparams)


# ---------------------------------------------------------------------------
# slow: the chain proved for real on the CPU, and the production ROMs
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_keccak_session_and_union_proved_cpu():
    """keccak guest -> rv32im segment STARK -> lift; its batch -> KeccakAir
    STARK -> lift_keccak; resolve_coproc -> session receipt; then a second
    batch chained after it and the union of the two lifts, all proved and
    verified by the port on the CPU at CI scale (not production
    soundness)."""
    cparams = cs.CoprocParams(kec_po2=KEC_PO2, kec_ps=CI_PS,
                              rec_po2=CI_REC_PO2, rec_ps=CI_PS)
    params = succinct.SuccinctParams(seg_po2=GUEST_PO2, seg_ps=CI_PS,
                                     rec_po2=CI_MAIN_REC_PO2, rec_ps=CI_PS,
                                     variants=("rv32im",))
    system = succinct.SuccinctSystem(params, coproc=cparams, device="cpu")
    csys = system.coproc_sys
    image = guests.keccak_guest()
    ex = Executor(image, guests.words([]), segment_po2=GUEST_PO2)
    res = ex.run()
    seg = res.segments[0]
    sr = prove.prove_segment(image, seg, CI_PS, device="cpu",
                             rng=np.random.default_rng(0))
    lift = system.lift(sr, succinct.segment_pre_chains(ex, res)[0],
                       seg.pre_mem, 0)
    ((kr, klift),) = _coproc_lifts(csys, ex, KEC_PO2, ps=CI_PS,
                                   device="cpu")
    assert coproc.verify_keccak(kr, CI_PS) and csys.verify(klift)
    resolved = system.resolve_coproc(lift, klift)
    assert system.verify(resolved)
    words = [int(w) for w in ex.journal_words]
    with pytest.raises(succinct.SuccinctError):
        succinct.finalize_session(lift, words, image.entry,
                                  paging.image_root(image))
    session = succinct.finalize_session(resolved, words, image.entry,
                                        paging.image_root(image))
    assert succinct.verify_session(session, system)
    moved = dataclasses.replace(resolved, claim=dataclasses.replace(
        resolved.claim, post_coproc=(1,) * 8))
    assert not system.verify(moved)

    more = coproc.prove_keccak(_states(8, 3), KEC_PO2, CI_PS, device="cpu")
    klift2 = csys.lift(more, klift.claim.post_chain, klift.claim.post_count)
    u = csys.union(klift, klift2)
    assert csys.verify(u) and (u.claim.pre_count, u.claim.post_count) == (0, 4)
    with pytest.raises(ValueError):
        csys.union(klift2, klift)


PROD_KINDS = ["lift", "join", "resolve", "lift_keccak", "union",
              "resolve_coproc"]


@pytest.mark.slow
@pytest.mark.parametrize("kind", PROD_KINDS)
def test_production_rom_equals_jax_digest(kind, golden):
    root, cid = _placeholders(golden)
    prog = {"lift": lambda: succinct.build_lift(17, prove.DEFAULT_PS,
                                                "rv32im"),
            "join": lambda: succinct.build_join(21, Q50),
            "resolve": lambda: succinct.build_resolve(21, Q50),
            "lift_keccak": lambda: cs.build_lift_keccak(10, Q50),
            "union": lambda: cs.build_union(21, Q50),
            "resolve_coproc": lambda: succinct.build_resolve_coproc(
                21, Q50, root, 21, Q50, cid)}[kind]()
    assert len(prog.rows) == int(golden[f"prod/{kind}/rows"])
    rom = prog.finalize(1 << 21).ctrl_trace_np()
    assert hashlib.sha256(rom.astype("<u4").tobytes()).hexdigest() == \
        str(golden[f"prod/{kind}/rom_sha256"])
