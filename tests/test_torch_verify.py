"""The port's verifier on the JAX golden proofs: it accepts them, and
rejects a tampered proof word and a tampered public claim."""

import dataclasses

import pytest

from boundless_tpu_torch import convert
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import prove

from test_torch_prove import PO2, golden


@pytest.mark.parametrize("variant", ["rv32im", "rv32i"])
def test_port_verifier_accepts_golden_rejects_tamper(variant):
    _, _, pub, gold = golden(variant)
    air = prove._AIRS[variant]
    root = convert.tensor(gold["ctrl_root"])

    def verify(flat, pub_values):
        return bool(stark.verify(air, convert.proof_from_numpy(flat),
                                 pub_values, PO2, root, prove.TEST_PS))

    assert verify(gold, pub)
    taps = gold["taps_data"].copy()
    taps[5, 0, 1] ^= 1
    assert not verify({**gold, "taps_data": taps}, pub)
    io = pub.io.clone()
    io[0, 2] = (io[0, 2] + 1) % F.P
    assert not verify(gold, dataclasses.replace(pub, io=io))
