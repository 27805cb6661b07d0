"""The keccak coprocessor AIR and its batch receipts on the CPU: the port
against the JAX package on the same inputs, tolerance 0 (field words).

Witness, control trace and circuit id, public LogUp sum and accumulator
equal JAX's at kec_po2 7; every constraint vanishes pointwise on the
witness rows under the port's eager algebra, within the degree budget;
the port's CPU proof of the golden batch equals the JAX proof stored in
`tests/data/torch_keccak_golden.npz` word for word, the golden proof
verifies under the port's verifier and a bumped public limb or proof word
is rejected; dev-mode receipts and the aggregation union give the JAX
package's digests (mirroring `tests/test_keccak.py`)."""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from boundless_tpu.air import keccak as JK
from boundless_tpu.core import field as JF
from boundless_tpu.zkvm import coproc as JCO
from boundless_tpu.zkvm.executor import keccak_f1600 as exec_f1600
from boundless_tpu.zkvm.executor import keccak_perm_digest
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import dsl
from boundless_tpu_torch.air import keccak as K
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import coproc

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_keccak_golden.npz")
PO2 = 7
N = 1 << PO2
KEC_PS = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _states(seed, n):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, 1 << 64, size=25,
                                          dtype=np.uint64)]
            for _ in range(n)]


def _golden_states(g):
    return [[int(x) for x in row] for row in g["kec/states"]]


def _golden_receipt(g) -> coproc.KeccakReceipt:
    flat = {"po2": np.array(PO2), "count": np.array(len(g["kec/states"])),
            "states_pub": g["kec/states_pub"]}
    flat.update({"proof." + k[len("kec/proof."):]: g[k] for k in g.files
                 if k.startswith("kec/proof.")})
    return convert.keccak_receipt_from_numpy(flat)


def _globals(seed):
    g = np.random.default_rng(seed).integers(0, F.P, size=(2, 4))
    return F.fp(g), JF.fp(g)


def _same(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want).astype(np.uint32))


@pytest.mark.parametrize("po2,perms", [(6, 1), (7, 3), (7, 5)])
def test_witness_equals_jax(po2, perms):
    st = _states(po2 * 10 + perms, perms)
    data, pub, outs = K.witness(st, po2)
    jdata, jpub, jouts = JK.witness(st, po2)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(pub["states"], jpub["states"])
    assert outs == jouts
    m = (1 << 64) - 1
    assert outs[:perms] == [[v & m for v in exec_f1600(list(s))] for s in st]
    assert [K.keccak_f1600(s) for s in st] == outs[:perms]


def test_ctrl_trace_and_circuit_id_equal_jax(golden):
    _same(K.AIR.ctrl_trace(N), JK.AIR.ctrl_trace(N))
    assert K.max_perms(PO2) == JK.max_perms(PO2) == 5
    cid = coproc.circuit_id(PO2, KEC_PS, device="cpu")
    assert cid == tuple(int(x) for x in golden["kec/circuit_id"])


def test_public_sum_and_accum_trace_equal_jax():
    st = _states(3, 2)
    data, pub, _ = K.witness(st, PO2)
    gl, jgl = _globals(11)
    kp = K.PublicValues(states=F.fp(pub["states"]))
    jkp = JK.PublicValues(states=JF.fp(pub["states"]))
    _same(K.public_logup_sum(kp, gl[0], gl[1]),
          JK.public_logup_sum(jkp, jgl[0], jgl[1]))
    acc = K.AIR.accum_trace(K.AIR.ctrl_trace(N), F.fp(data), gl)
    _same(acc, JK.AIR.accum_trace(JK.AIR.ctrl_trace(N), JF.fp(data), jgl))


def _constraint_values(data, states, gl):
    ctrl = K.AIR.ctrl_trace(N)
    dt = F.fp(data)
    acc = K.AIR.accum_trace(ctrl, dt, gl)
    now = dsl.Columns(*(stark._ColAccessor(e) for e in (ctrl, dt, acc)))
    nxt = dsl.Columns(*(stark._ColAccessor(torch.roll(e, -1, 0))
                        for e in (ctrl, dt, acc)))
    cons = K.AIR.constraints(dsl.BaseAlg(), now, nxt, gl,
                             K.PublicValues(states=F.fp(states)))
    return [c.v if isinstance(c, (stark.ExtVal, stark.VecVal)) else c
            for c in cons]


def test_constraints_vanish_on_the_witness_within_the_budget():
    st = _states(5, 4)
    data, pub, _ = K.witness(st, PO2)
    gl, _ = _globals(13)
    values = _constraint_values(data, pub["states"], gl)
    assert len(values) == 17
    assert all(not torch.any(v != 0) for v in values)
    degs = [int(np.max(d)) for d in dsl.constraint_degrees(
        K.AIR, K.PublicValues(states=F.fp(pub["states"])))]
    assert max(degs) == K.AIR.max_degree == 5 and len(degs) == 17
    # a flipped public output limb breaks the last-row LogUp balance only
    bad = pub["states"].copy()
    bad[0, 1 + 100] ^= 1
    values = _constraint_values(data, bad, gl)
    assert [i for i, v in enumerate(values) if torch.any(v != 0)] == [16]


@pytest.fixture(scope="module")
def port_receipt(golden):
    return coproc.prove_keccak(_golden_states(golden), PO2, KEC_PS,
                               device="cpu")


def test_cpu_proof_equals_golden(golden, port_receipt):
    np.testing.assert_array_equal(port_receipt.states_pub,
                                  golden["kec/states_pub"])
    flat = convert.proof_to_numpy(port_receipt.proof)
    want = {k[len("kec/proof."):]: golden[k] for k in golden.files
            if k.startswith("kec/proof.")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, k)


def test_golden_proof_verifies_and_tampers_are_rejected(golden):
    r = _golden_receipt(golden)
    assert coproc.verify_keccak(r, KEC_PS)
    bad_pub = r.states_pub.copy()
    bad_pub[0, 5] ^= 1
    assert not coproc.verify_keccak(
        dataclasses.replace(r, states_pub=bad_pub), KEC_PS)
    fc = r.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    bumped = r.proof._replace(fri_proof=r.proof.fri_proof._replace(
        final_coeffs=fc))
    assert not coproc.verify_keccak(dataclasses.replace(r, proof=bumped),
                                    KEC_PS)


def test_keccak_receipt_converters_round_trip(golden, port_receipt):
    flat = convert.keccak_receipt_to_numpy(port_receipt)
    back = convert.keccak_receipt_from_numpy(flat)
    assert back.po2 == PO2 and back.count == port_receipt.count
    np.testing.assert_array_equal(back.states_pub, port_receipt.states_pub)
    again = convert.keccak_receipt_to_numpy(back)
    assert sorted(again) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, k)
    assert back.digests() == port_receipt.digests()


def test_dev_mode_receipts_and_union_equal_jax():
    st, more = _states(21, 3), _states(22, 1)
    r = coproc.prove_keccak(st, po2=8, dev_mode=True)
    jr = JCO.prove_keccak(st, po2=8, dev_mode=True)
    assert r.proof is None and r.count == 3
    np.testing.assert_array_equal(r.states_pub, jr.states_pub)
    want = [keccak_perm_digest(s, exec_f1600(list(s))) for s in st]
    assert r.digests() == jr.digests() == want
    u = coproc.union(r, coproc.prove_keccak(more, po2=8, dev_mode=True))
    ju = JCO.union(jr, JCO.prove_keccak(more, po2=8, dev_mode=True))
    assert len(u.digests()) == 4 and u.digests() == ju.digests()
    assert coproc.verify_union(u, dev_mode=True)
    assert not coproc.verify_union(u)
    assert not coproc.verify_keccak(r)


def test_keccak_entry_points_default_to_the_card():
    for fn in (coproc.circuit_id, coproc.prove_keccak):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coproc.circuit_id(PO2, KEC_PS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coproc.prove_keccak(_states(1, 1), PO2, KEC_PS)
