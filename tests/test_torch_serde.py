"""The port's wire formats against the JAX package's `utils/serde.py`.

A port object must dump to the same bytes as the JAX object it converts
to: the po2-8 segment proof of `tests/data/torch_golden_po2_8.npz` (as a
proof, a `SegmentReceipt` and through `dump_segment_receipt`), the
RecursionAir receipt of `torch_rec_golden.npz` and a dev-mode session
receipt of the echo guest. Both sides are built from the same numpy
arrays (JAX's serde reads numpy and compiles nothing). Each package loads
the other's bytes, and the malformed, truncated, unknown-dataclass and
tamper cases of `tests/test_serde.py` raise `SerdeError` in the port too.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from boundless_tpu.core import fri as JFRI
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu.recursion import claims as JCLAIMS
from boundless_tpu.recursion import succinct as JSU
from boundless_tpu.utils import serde as JSERDE
from boundless_tpu.zkvm import guests as JGUESTS
from boundless_tpu.zkvm import prove as JPROVE
from boundless_tpu.zkvm.executor import Executor as JExecutor
from boundless_tpu_torch import convert
from boundless_tpu_torch.recursion import claims, succinct
from boundless_tpu_torch.utils import serde
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
PO2 = 8


def _flat(path, prefix):
    g = np.load(os.path.join(DATA, path))
    return g, {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}


def jax_proof(flat):
    """The JAX package's SegmentProof of a flat proof dict (numpy leaves,
    as a loaded JAX receipt holds them)."""
    def opening(name):
        if f"{name}.rows" not in flat:
            return None
        return JSTARK.GroupOpening(flat[f"{name}.rows"], flat[f"{name}.paths"])

    def listed(name):
        keys = sorted((k for k in flat if k.startswith(f"fri_proof.{name}.")),
                      key=lambda k: int(k.rsplit(".", 1)[1]))
        return tuple(flat[k] for k in keys)

    fields = {}
    for name in JSTARK.SegmentProof._fields:
        if name.startswith("open_"):
            fields[name] = opening(name)
        elif name == "fri_proof":
            fields[name] = JFRI.FriProof(
                listed("round_roots"), listed("round_rows"),
                listed("round_paths"), flat["fri_proof.final_coeffs"])
        else:
            fields[name] = flat.get(name)
    return JSTARK.SegmentProof(**fields)


def assert_flat_equal(proof, gold):
    flat = convert.proof_to_numpy(proof)
    assert sorted(flat) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(flat[k], gold[k], err_msg=k)


def _words(journal):
    return [int.from_bytes(journal[i: i + 4], "little")
            for i in range(0, len(journal), 4)]


@pytest.fixture(scope="module")
def dev_sessions():
    """The echo guest's dev-mode session in both packages: (segment,
    segment receipt, lift, session receipt) each."""
    def run(g, executor, pv, su, **dev):
        img = g.echo()
        res = executor(img, g.words([2, 11, 22]), segment_po2=PO2).run()
        seg = res.segments[0]
        sr = pv.dev_receipt(img, seg, ps=pv.TEST_PS, **dev)
        lifted = su.DevModeSystem().lift(sr)
        session = su.finalize_session(lifted, _words(res.journal),
                                      entry_pc=img.entry)
        return seg, sr, lifted, session

    return (run(JGUESTS, JExecutor, JPROVE, JSU),
            run(guests, Executor, prove, succinct, device="cpu"))


def test_image_bytes_equal_and_round_trip():
    img = guests.echo()
    data = serde.dump_image(img)
    assert data == JSERDE.dump_image(JGUESTS.echo())
    back = serde.load_image(data)
    assert back.words == img.words and back.entry == img.entry
    assert back.image_id() == img.image_id()
    jback = JSERDE.load_image(data)
    assert jback.words == img.words and jback.entry == img.entry


@pytest.mark.parametrize("variant", ["rv32im", "rv32i"])
def test_segment_proof_bytes_equal_jax(variant, dev_sessions):
    _, gold = _flat("torch_golden_po2_8.npz", f"{variant}/proof.")
    port, jax = convert.proof_from_numpy(gold), jax_proof(gold)
    data = serde.dump_obj(port, "proof")
    assert data == JSERDE.dump_obj(jax, "proof")
    # loads in both directions
    back = serde.load_obj(JSERDE.dump_obj(jax, "proof"), "proof")
    assert all(t.dtype == torch.int32 for t in back[:8])
    assert_flat_equal(back, gold)
    assert_flat_equal(JSERDE.load_obj(data, "proof"), gold)

    # the receipt around it: a dataclass dump and dump_segment_receipt
    (_, jsr, _, _), (_, sr, _, _) = dev_sessions
    assert sr.image_id.dtype == jsr.image_id.dtype == np.uint32
    port_r = dataclasses.replace(sr, proof=port, variant=variant)
    jax_r = dataclasses.replace(jsr, proof=jax, variant=variant)
    assert serde.dump_obj(port_r, "r") == JSERDE.dump_obj(jax_r, "r")
    data = serde.dump_segment_receipt(port_r)
    assert data == JSERDE.dump_segment_receipt(jax_r)
    back = serde.load_segment_receipt(data)
    assert_flat_equal(back.proof, gold)
    np.testing.assert_array_equal(back.image_id, sr.image_id)
    assert back.po2 == PO2
    # like the reference, the segment-receipt format carries no variant
    assert back.variant == "rv32im"
    jback = JSERDE.load_segment_receipt(data)
    np.testing.assert_array_equal(jback.image_id, jsr.image_id)


def _rec_receipts():
    g, gold = _flat("torch_rec_golden.npz", "demo/proof.")
    rng = np.random.default_rng(9)
    fields = {f.name: tuple(int(x) for x in rng.integers(0, 1 << 30, 8))
              for f in dataclasses.fields(claims.Claim)
              if f.name not in ("pre_pc", "post_pc", "halted",
                                "pre_segments", "post_segments")}
    fields.update(pre_pc=4096, post_pc=4200, halted=1, pre_segments=0,
                  post_segments=2,
                  pre_regs=tuple(range(64)), post_regs=tuple(range(1, 65)),
                  pre_seqs=(0, 0, 0), post_seqs=(1, 2, 0))
    pub_vals = tuple(int(x) for x in g["demo/pub_vals"])
    port = succinct.RecReceipt(kind="join",
                               proof=convert.proof_from_numpy(gold),
                               claim=claims.Claim(**fields),
                               pub_vals=pub_vals, po2=PO2)
    jax = JSU.RecReceipt(kind="join", proof=jax_proof(gold),
                         claim=JCLAIMS.Claim(**fields), pub_vals=pub_vals,
                         po2=PO2)
    return gold, port, jax


def test_recursion_receipt_bytes_equal_jax():
    gold, port, jax = _rec_receipts()
    data = serde.dump_obj(port, "rec_receipt")
    assert data == JSERDE.dump_obj(jax, "rec_receipt")
    back = serde.load_obj(data, "rec_receipt")
    assert isinstance(back, succinct.RecReceipt)
    assert (back.kind, back.claim, back.pub_vals, back.po2) == \
        (port.kind, port.claim, port.pub_vals, port.po2)
    assert_flat_equal(back.proof, gold)
    jback = JSERDE.load_obj(data, "rec_receipt")
    assert jback.claim == jax.claim
    # a session receipt around it
    session = succinct.SuccinctSessionReceipt(
        root=port, journal=b"\x01\x00\x00\x00", image_id=port.claim.image_id,
        entry_pc=4096, image_mem_root=(5,) * 8)
    jsession = JSU.SuccinctSessionReceipt(
        root=jax, journal=b"\x01\x00\x00\x00", image_id=jax.claim.image_id,
        entry_pc=4096, image_mem_root=(5,) * 8)
    data = serde.dump_session_receipt(session)
    assert data == JSERDE.dump_session_receipt(jsession)
    back = serde.load_session_receipt(data)
    assert back.image_mem_root == (5,) * 8
    assert_flat_equal(back.root.proof, gold)


def test_dev_session_receipt_bytes_equal_jax(dev_sessions):
    (jseg, jsr, jlift, jsession), (seg, sr, lift, session) = dev_sessions
    assert serde.dump_segment(seg) == JSERDE.dump_segment(jseg)
    assert serde.dump_obj(sr, "hot") == JSERDE.dump_obj(jsr, "hot")
    assert serde.dump_obj(lift, "hot") == JSERDE.dump_obj(jlift, "hot")
    data = serde.dump_session_receipt(session)
    assert data == JSERDE.dump_session_receipt(jsession)
    back = serde.load_session_receipt(JSERDE.dump_session_receipt(jsession))
    assert isinstance(back, succinct.SuccinctSessionReceipt)
    assert back.journal == session.journal
    assert succinct.verify_session(back, succinct.DevModeSystem())
    jback = JSERDE.load_session_receipt(data)
    assert JSU.verify_session(jback, JSU.DevModeSystem())
    back_seg = serde.load_segment(JSERDE.dump_segment(jseg))
    assert back_seg.pre_mem == seg.pre_mem and back_seg.index == seg.index
    assert back_seg.pre_seqs == seg.pre_seqs


def test_to_cpu_keeps_host_objects():
    """On the CPU there is nothing to move: the walk gives back the same
    objects (tests/test_torch_cluster_remote.py moves a card's receipt)."""
    _, port, _ = _rec_receipts()
    assert serde.to_cpu(port) is port
    nested = {"a": [port.proof, (1, b"x")], "b": None}
    assert serde.to_cpu(nested) is nested


# ---------------------------------------------------------------------------
# malformed input (the cases of tests/test_serde.py, on the port)
# ---------------------------------------------------------------------------


def test_image_rejects_malformed():
    with pytest.raises(serde.SerdeError):
        serde.load_image(b"NOPE" + b"\0" * 32)
    good = serde.dump_image(guests.echo())
    with pytest.raises(serde.SerdeError):
        serde.load_image(good[:-4])
    bad = bytearray(good)
    bad[4] = 99
    with pytest.raises(serde.SerdeError):
        serde.load_image(bytes(bad))
    with pytest.raises(serde.SerdeError):
        serde.load_image(pickle.dumps(guests.echo()))


def test_pytree_roundtrip_and_bad_magic():
    obj = {"a": np.arange(12, dtype=np.uint32).reshape(3, 4),
           "b": [1, "two", b"\x03\x04", None],
           "c": {"nested": np.float32(2.5) * np.ones(2, np.float32)},
           "d": (7, 8)}
    data = serde.dump_pytree(obj)
    assert data == JSERDE.dump_pytree(obj)
    back = serde.load_pytree(data)
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["b"] == [1, "two", b"\x03\x04", None] and back["d"] == (7, 8)
    with pytest.raises(serde.SerdeError):
        serde.load_pytree(b"XXXX" + data[4:])
    with pytest.raises(serde.SerdeError):
        serde.load_pytree(b"BTPT\xff\xff\x00\x00{}")  # header past the end
    with pytest.raises(serde.SerdeError):
        serde.load_pytree(b"BTPT\x02\x00\x00\x00\xff\xfe")  # not JSON
    d = {4096: 7, 0: 2**63, 12: 0}
    assert serde.load_pytree(serde.dump_pytree(d)) == d
    d2 = {(1, 2): "a", 5: [1, 2]}
    assert serde.load_pytree(serde.dump_pytree(d2)) == d2


def test_session_receipt_tamper_and_wire_errors(dev_sessions):
    _, (_, _, _, session) = dev_sessions
    data = serde.dump_session_receipt(session)
    back = serde.load_session_receipt(data)
    system = succinct.DevModeSystem()
    assert succinct.verify_session(back, system)
    forged = dataclasses.replace(back, journal=b"\x99" + back.journal[1:])
    assert not succinct.verify_session(forged, system)
    with pytest.raises(serde.SerdeError):
        serde.load_obj(data, "segment")
    with pytest.raises(serde.SerdeError):
        serde.load_session_receipt(data[: len(data) // 2])
    bumped = serde.dump_pytree({"kind": "session_receipt", "version": 99,
                                "obj": None})
    with pytest.raises(serde.SerdeError):
        serde.load_session_receipt(bumped)
    _, port, _ = _rec_receipts()
    proof_bytes = serde.dump_obj(port, "rec_receipt")
    with pytest.raises(serde.SerdeError):
        serde.load_obj(proof_bytes[:-8], "rec_receipt")  # truncated arrays


def test_unknown_dataclass_rejected():
    @dataclasses.dataclass
    class Evil:
        x: int

    data = serde.dump_pytree({"kind": "hot", "version": 1, "obj": Evil(1)})
    with pytest.raises(serde.SerdeError):
        serde.load_pytree(data)
