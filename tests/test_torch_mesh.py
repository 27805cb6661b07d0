"""Data-parallel segment proving (`boundless_tpu_torch/parallel/mesh.py`)
on the CPU: a dp = 2 mesh over two CPU devices proves two po2-8 echo
segments (TEST_PS, rv32im); each proof equals `stark.prove` of that
segment alone word for word, and the golden segment's proof equals the
JAX package's in `tests/data/torch_golden_po2_8.npz` (tolerance 0: field
words). The reference's (dp, tp) factorisation, and a mesh with tp > 1
refused (column sharding is not ported)."""

import os

import numpy as np
import pytest
import torch

from boundless_tpu_torch import convert
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.parallel import mesh as M
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import guests, prove, witness
from boundless_tpu_torch.zkvm.executor import Executor

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_po2_8.npz")
PO2 = 8
AIR = prove._AIRS["rv32im"]


def _golden():
    g = np.load(GOLDEN)
    pre = "rv32im/"
    pub = convert.pub_from_numpy({k[len(pre + "in.pub."):]: g[k]
                                  for k in g.files
                                  if k.startswith(pre + "in.pub.")})
    gold = {k[len(pre + "proof."):]: g[k] for k in g.files
            if k.startswith(pre + "proof.")}
    return (F.fp(g[pre + "in.data"].astype(np.int64)),
            F.fp(g[pre + "in.ctrl"].astype(np.int64)), pub, gold)


def _second_segment():
    """Another echo segment (other input, seeded blinding) on the same
    control trace."""
    image = guests.echo()
    seg = Executor(image, guests.words([3, 5, 6, 7]),
                   segment_po2=PO2).run().segments[0]
    w = witness.trace_segment(image, seg, PO2, np.random.default_rng(11))
    return (F.fp(witness.data_for_variant(w.data, "rv32im")),
            witness.to_public_values(w.pub))


def _equal(a, b) -> bool:
    fa, fb = convert.proof_to_numpy(a), convert.proof_to_numpy(b)
    return sorted(fa) == sorted(fb) and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.fixture(scope="module")
def batch():
    data0, ctrl, pub0, gold = _golden()
    data1, pub1 = _second_segment()
    return [data0, data1], [pub0, pub1], ctrl, gold


def test_dp2_proofs_equal_single_and_golden(batch):
    data, pubs, ctrl, gold = batch
    mesh = M.make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"dp": 2, "tp": 1}
    fn, shard_fn = M.shard_batched_prover(AIR, PO2, prove.TEST_PS, mesh)
    proofs = fn(*shard_fn(torch.stack(data), pubs, ctrl))
    assert len(proofs) == 2
    for d, p, got in zip(data, pubs, proofs):
        assert _equal(got, stark.prove(AIR, d, p, PO2, prove.TEST_PS, ctrl))
    flat = convert.proof_to_numpy(proofs[0])
    assert sorted(flat) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(flat[k], gold[k], err_msg=k)
    assert not _equal(proofs[0], proofs[1])


def test_batched_publics_unbatch(batch):
    data, pubs, ctrl, _ = batch
    stacked = type(pubs[0])(**{
        f: torch.stack([getattr(p, f) for p in pubs])
        for f in vars(pubs[0])})
    mesh = M.make_mesh(devices=["cpu"])
    _, shard_fn = M.shard_batched_prover(AIR, PO2, prove.TEST_PS, mesh)
    placed, got, same = shard_fn(data, stacked, ctrl)
    assert len(placed) == 2 and same is ctrl
    for want, p in zip(pubs, got):
        for f in vars(want):
            assert torch.equal(getattr(p, f), getattr(want, f))


def test_tp_above_one_raises():
    mesh = M.make_mesh(devices=["cpu", "cpu"], dp=1)
    assert mesh.shape == {"dp": 1, "tp": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.shard_batched_prover(AIR, PO2, prove.TEST_PS, mesh)


@pytest.mark.parametrize("n,dp,tp", [(1, 1, 1), (2, 2, 1), (4, 4, 1),
                                     (6, 2, 3), (8, 8, 1), (3, 1, 3)])
def test_mesh_factorisation(n, dp, tp):
    from boundless_tpu.parallel import mesh as JM

    mesh = M.make_mesh(devices=["cpu"] * n)
    assert mesh.shape == {"dp": dp, "tp": tp}
    assert mesh.axis_names == ("dp", "tp")
    assert mesh.shape == dict(JM.make_mesh(n).shape)  # 8 host devices


def test_mesh_without_devices_raises():
    with pytest.raises(ValueError):
        M.make_mesh(devices=[])
