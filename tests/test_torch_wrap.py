"""The port's Groth16 wrap circuit at a small size, against the JAX package.

The p254-suite toy proof (ProdAir, n = 32, 4 queries) given the 24
publics that `circuit.build_verifier` requires goes through the port's
verifier circuit; its R1CS (rows and witness, by sha256) and the trapdoor
Groth16 proof with a fixed random source equal the JAX package's, held in
`tests/data/torch_wrap_golden.npz` (regenerate with `JAX_PLATFORMS=cpu
python tests/data/make_torch_wrap_golden.py`, about 2 minutes: JAX's side
is mostly XLA compile). The proof verifies under both packages'
`protocol.verify`. The full CI wrap chain (`tests/test_groth16_wrap.py`'s
session: echo guest, seg po2 6, rec_po2 17) runs on the port as one slow
test. Tolerance 0: exact field and group arithmetic.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from boundless_tpu.groth16 import bn254 as JBN
from boundless_tpu.groth16 import protocol as JPROTO
from boundless_tpu_torch import convert
from boundless_tpu_torch.groth16 import circuit, protocol, qap, r1cs
from boundless_tpu_torch.groth16.bn254 import G1
from boundless_tpu_torch.kernels import poseidon254 as P254K

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "data"))
import make_torch_wrap_golden as GOLD  # noqa: E402
from test_torch_poseidon254 import TOY_PO2, TOY_PS, prove_toy  # noqa: E402

GOLDEN = os.path.join(HERE, "data", "torch_wrap_golden.npz")


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def toy():
    torch.set_num_threads(1)
    return prove_toy(GOLD.TOY_PUB)


@pytest.fixture(scope="module")
def wrapped(toy):
    """The port's verifier circuit over the toy proof, and its trapdoor
    Groth16 proof with the golden's random source."""
    air, proof, root = toy
    bld = r1cs.Builder(concrete=True)
    pub_felts = circuit.build_verifier(
        bld, air, TOY_PO2, TOY_PS, [int(x) for x in P254K.words_np(root)],
        proof=proof, pub_vals=GOLD.TOY_PUB)
    sys_ = bld.to_sparse()
    wit = bld.witness()
    rng = GOLD.fixed_rng(GOLD.TRAPDOOR_SEED)
    td, vk = qap.setup_trapdoor(sys_, rng=rng)
    g = qap.prove_with_trapdoor(sys_, td, wit, rng=rng)
    assert len(pub_felts) == sys_.n_pub == 3
    publics = wit[1:1 + sys_.n_pub]  # variable 0 is the constant 1
    return sys_, wit, vk, g, publics


def test_toy_proof_equals_the_golden(toy, gold):
    _, proof, root = toy
    flat = convert.proof_to_numpy(proof)
    keys = {k[4:] for k in gold if k.startswith("toy/")} - {"control_root"}
    assert set(flat) == keys
    for k in flat:
        np.testing.assert_array_equal(flat[k], gold[f"toy/{k}"], err_msg=k)
    np.testing.assert_array_equal(P254K.words_np(root),
                                  gold["toy/control_root"])


def test_r1cs_rows_and_witness_equal_jax(wrapped, gold):
    sys_, wit, _, _, _ = wrapped
    assert len(sys_.rows) == int(gold["r1cs/n_rows"])
    assert sys_.n_vars == int(gold["r1cs/n_vars"])
    assert sys_.n_pub == int(gold["r1cs/n_pub"])
    assert GOLD.rows_sha256(sys_.rows) == str(gold["r1cs/rows_sha256"])
    assert GOLD.witness_sha256(wit) == str(gold["r1cs/witness_sha256"])


def test_layout_mode_emits_the_same_rows(toy, wrapped):
    air, _, root = toy
    bld = r1cs.Builder(concrete=False)
    circuit.build_verifier(bld, air, TOY_PO2, TOY_PS,
                           [int(x) for x in P254K.words_np(root)])
    layout = bld.to_sparse()
    sys_ = wrapped[0]
    assert (len(layout.rows), layout.n_vars) == (len(sys_.rows), sys_.n_vars)
    assert GOLD.rows_sha256(layout.rows) == GOLD.rows_sha256(sys_.rows)


def test_trapdoor_proof_equals_jax(wrapped, gold):
    _, _, vk, g, _ = wrapped
    np.testing.assert_array_equal(GOLD.g1_words(g.a), gold["groth16/a"])
    np.testing.assert_array_equal(GOLD.g2_words(g.b), gold["groth16/b"])
    np.testing.assert_array_equal(GOLD.g1_words(g.c), gold["groth16/c"])
    np.testing.assert_array_equal(GOLD.g1_words(vk.alpha_g1),
                                  gold["groth16/vk_alpha"])
    np.testing.assert_array_equal(
        np.stack([GOLD.g1_words(p) for p in vk.ic]), gold["groth16/vk_ic"])


def test_trapdoor_proof_verifies_under_both_packages(wrapped):
    _, _, vk, g, publics = wrapped
    assert protocol.verify(vk, g, publics)
    jvk = convert.groth16_from_ints(JPROTO.VerifyingKey,
                                    convert.groth16_to_ints(vk), JBN.G1)
    jg = convert.groth16_from_ints(JPROTO.Proof, convert.groth16_to_ints(g),
                                   JBN.G1)
    assert JPROTO.verify(jvk, jg, publics)
    bad = list(publics)
    bad[0] = (bad[0] + 1) % protocol.R
    assert not JPROTO.verify(jvk, jg, bad)
    assert not protocol.verify(vk, dataclasses.replace(g, a=G1.generator()),
                               publics)


def toy_claim():
    from boundless_tpu_torch.recursion import claims

    z8 = tuple(range(8))
    return claims.Claim(image_id=z8, pre_pc=4, post_pc=8, halted=1,
                        pre_regs=(0,) * 64, post_regs=(1,) * 64,
                        pre_seqs=(0, 0, 0, 0), post_seqs=(1, 0, 0, 0),
                        pre_journal=z8, post_journal=z8, pre_input=z8,
                        post_input=z8, pre_assumptions=z8,
                        post_assumptions=z8)


def test_p254_receipt_converters_round_trip(toy):
    from boundless_tpu_torch.recursion import identity

    _, proof, _ = toy
    r = identity.P254Receipt(proof=proof, claim=toy_claim(),
                             pub_vals=tuple(GOLD.TOY_PUB), po2=TOY_PO2)
    flat = convert.p254_receipt_to_numpy(r)
    back = convert.p254_receipt_from_numpy(flat)
    assert back.claim == r.claim and back.pub_vals == r.pub_vals
    again = convert.p254_receipt_to_numpy(back)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k], err_msg=k)


def test_seal_and_receipt_converters_round_trip(wrapped):
    from boundless_tpu_torch.groth16 import wrap

    _, _, vk, g, publics = wrapped
    seal = wrap.Groth16Seal(proof=g, vk=vk, publics=tuple(publics),
                            claim=toy_claim(), entry_pc=4,
                            image_mem_root=None, allowed_root=(5,) * 8)
    receipt = wrap.Groth16Receipt(
        kind="groth16", selector=wrap.SELECTOR_GROTH16,
        claim_digest=b"\x01" * 32, journal=b"\x07\x00\x00\x00",
        image_id=(0,) * 8, dev_mode=False, inner=seal)
    back = convert.groth16_receipt_from_ints(
        convert.groth16_receipt_to_ints(receipt))
    for f in ("kind", "selector", "claim_digest", "journal", "image_id",
              "dev_mode"):
        assert getattr(back, f) == getattr(receipt, f), f
    for f in ("publics", "claim", "entry_pc", "image_mem_root",
              "allowed_root"):
        assert getattr(back.inner, f) == getattr(seal, f), f
    for f in ("proof", "vk"):
        assert convert.groth16_to_ints(getattr(back.inner, f)) == \
            convert.groth16_to_ints(getattr(seal, f)), f
    assert protocol.verify(back.inner.vk, back.inner.proof, publics)


# -- the CI wrap chain (slow) ------------------------------------------------


@pytest.mark.slow
def test_identity_rom_and_p254_control_id_equal_jax():
    """build_identity's ROM at rec_po2 17 (the CI params) and its p254
    control ID, from both packages (minutes: the control ID hashes a
    2^16 x 48 LDE with Python ints in both)."""
    from boundless_tpu.prover import stark as JSTARK
    from boundless_tpu.recursion import air as JAIR
    from boundless_tpu.recursion import identity as JID
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import air as rair
    from boundless_tpu_torch.recursion import identity

    args = dict(queries=2, fri_min_degree=16, commit_expand=2)
    ps, jps = stark.ProofSystem(**args), JSTARK.ProofSystem(**args)
    prog, jprog = identity.build_identity(17, ps), JID.build_identity(17, jps)
    assert len(prog.rows) == len(jprog.rows)
    po2 = max(8, (len(prog.rows) + 1).bit_length())
    n = 1 << po2
    prog.finalize(n)
    jprog.finalize(n)
    np.testing.assert_array_equal(prog.ctrl_trace_np(), jprog.ctrl_trace_np())
    root = stark.control_root_of(
        rair.AIR, po2, rair.rom_trace(prog, n, "cpu"),
        dataclasses.replace(ps, hash="poseidon254"))
    jroot = JSTARK.control_root_of(
        JAIR.AIR, po2, JAIR.rom_trace(jprog, n),
        dataclasses.replace(jps, hash="poseidon254"))
    np.testing.assert_array_equal(P254K.words_np(root),
                                  np.asarray(jroot, dtype=np.uint32))


@pytest.mark.slow
def test_ci_wrap_chain_on_the_port():
    """tests/test_groth16_wrap.py's chain on the port, on the CPU: echo
    session -> lift -> finalize -> identity_p254 -> R1CS wrap circuit ->
    trapdoor Groth16; pairing-only verification, tampers refused, the EVM
    seal round-trips."""
    from boundless_tpu_torch.groth16 import evm, wrap
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import identity, succinct
    from boundless_tpu_torch.zkvm import guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    ps = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
    params = succinct.SuccinctParams(seg_po2=6, seg_ps=ps, rec_po2=17,
                                     rec_ps=ps)
    image = guests.echo()
    res = Executor(image, guests.words([1, 7]), segment_po2=6).run()
    system = succinct.SuccinctSystem(params, device="cpu")
    sr = prove.prove_segment(image, res.segments[0], ps, device="cpu")
    root = system.lift(sr, pre_mem=res.segments[0].pre_mem)
    words = [int.from_bytes(res.journal[i: i + 4], "little")
             for i in range(0, len(res.journal), 4)]
    session = succinct.finalize_session(root, words, image.entry,
                                        paging.image_root(image))
    receipt = wrap.compress(session, kind="groth16", system=system)
    assert receipt.dev_mode is False
    assert wrap.verify(receipt, system=system)
    assert identity.get_p254(system).verify(
        identity.get_p254(system).shrink(session.root))
    bad = dataclasses.replace(receipt, journal=receipt.journal[:-4]
                              + b"\x01\x02\x03\x04")
    assert not wrap.verify(bad, system=system)
    seal = receipt.inner
    bad_claim = dataclasses.replace(seal.claim, post_journal=tuple([1] * 8))
    assert not wrap.verify(dataclasses.replace(
        receipt, inner=dataclasses.replace(seal, claim=bad_claim)),
        system=system)
    calldata = evm.encode_seal(receipt)
    assert evm.verify_decoded(evm.decode_seal(calldata), seal.vk)
