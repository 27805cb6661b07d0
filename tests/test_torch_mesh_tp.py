"""Column-sharded proving (the mesh's tp axis, `parallel/mesh.py`) on the
CPU, on meshes that name the CPU several times. Tolerance 0 throughout
(field words).

tp = 2 and 3 proofs of the po2-8 golden segment, in rv32im and rv32i,
equal the JAX package's proofs in `tests/data/torch_golden_po2_8.npz` and
`stark.prove` of the whole trace; a dp 2 x tp 2 mesh proves two segments;
a tp-2 KeccakAir proof (4048 data columns) equals
`tests/data/torch_keccak_golden.npz`. (The JAX package's own tp compiles
for minutes on virtual CPU devices; its multi-chip dry run found its tp
proofs bit-identical to its one-chip proofs, so its goldens stand in.)
Then the parts: `column_split`'s blocks, the sponge chained through them
against whole rows, per-position weighted sums added mod P against the
whole sum, and the refusal of a group that mixes device types.
"""

import os

import numpy as np
import pytest
import torch

from boundless_tpu_torch import convert
from boundless_tpu_torch.air import keccak as K
from boundless_tpu_torch.core import bbmm
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import merkle
from boundless_tpu_torch.core import poseidon2 as P2
from boundless_tpu_torch.core import sharded as S
from boundless_tpu_torch.parallel import mesh as M
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import prove

from test_torch_mesh import _second_segment

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_golden_po2_8.npz")
KEC_GOLDEN = os.path.join(HERE, "data", "torch_keccak_golden.npz")
PO2 = 8
KEC_PO2 = 7
KEC_PS = stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)
COLS = (1, 8, 15, 16, 17, 32, 40, 392, 584, 4048)
TPS = (1, 2, 3, 4, 8)


def _golden(variant):
    g = np.load(GOLDEN)
    pre = f"{variant}/"
    pub = convert.pub_from_numpy({k[len(pre + "in.pub."):]: g[k]
                                  for k in g.files
                                  if k.startswith(pre + "in.pub.")})
    gold = {k[len(pre + "proof."):]: g[k] for k in g.files
            if k.startswith(pre + "proof.")}
    return (F.fp(g[pre + "in.data"].astype(np.int64)),
            F.fp(g[pre + "in.ctrl"].astype(np.int64)), pub, gold)


def _assert_flat_equal(proof, want: dict):
    flat = convert.proof_to_numpy(proof)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


@pytest.fixture(scope="module", params=["rv32im", "rv32i"])
def golden(request):
    variant = request.param
    data, ctrl, pub, gold = _golden(variant)
    air = prove._AIRS[variant]
    single = stark.prove(air, data, pub, PO2, prove.TEST_PS, ctrl)
    return air, data, ctrl, pub, gold, convert.proof_to_numpy(single)


@pytest.mark.parametrize("tp", [2, 3])
def test_tp_proof_equals_golden_and_stark_prove(golden, tp):
    air, data, ctrl, pub, gold, single = golden
    mesh = M.make_mesh(devices=["cpu"] * tp, dp=1)
    assert mesh.shape == {"dp": 1, "tp": tp}
    fn, shard_fn = M.shard_batched_prover(air, PO2, prove.TEST_PS, mesh)
    placed, _, _ = shard_fn([data], [pub], ctrl)
    widths = [b.shape[1] for b in placed[0].blocks]
    assert widths == [b - a for a, b in S.column_split(air.data_cols, tp)]
    assert len(widths) == tp
    before = S.MOVED_BYTES
    proofs = fn(placed, [pub], ctrl)
    assert S.MOVED_BYTES > before
    _assert_flat_equal(proofs[0], gold)
    _assert_flat_equal(proofs[0], single)


def test_dp2_tp2_mesh_proves_two_segments():
    data0, ctrl, pub0, gold = _golden("rv32im")
    data1, pub1 = _second_segment()
    air = prove._AIRS["rv32im"]
    mesh = M.make_mesh(devices=["cpu"] * 4, dp=2)
    assert mesh.shape == {"dp": 2, "tp": 2}
    fn, shard_fn = M.shard_batched_prover(air, PO2, prove.TEST_PS, mesh)
    proofs = fn(*shard_fn([data0, data1], [pub0, pub1], ctrl))
    _assert_flat_equal(proofs[0], gold)
    _assert_flat_equal(proofs[1], convert.proof_to_numpy(stark.prove(
        air, data1, pub1, PO2, prove.TEST_PS, ctrl)))


def test_keccak_tp2_proof_equals_golden():
    g = np.load(KEC_GOLDEN)
    states = [[int(x) for x in row] for row in g["kec/states"]]
    data, pub, _ = K.witness(states, KEC_PO2)
    mesh = M.make_mesh(devices=["cpu", "cpu"], dp=1)
    fn, shard_fn = M.shard_batched_prover(K.AIR, KEC_PO2, KEC_PS, mesh)
    placed, _, _ = shard_fn([F.fp(data)], [K.PublicValues(
        states=F.fp(pub["states"]))], None)
    assert [b.shape[1] for b in placed[0].blocks] == [2032, 2016]
    proofs = fn(placed, [K.PublicValues(states=F.fp(pub["states"]))], None)
    _assert_flat_equal(proofs[0], {k[len("kec/proof."):]: g[k]
                                   for k in g.files
                                   if k.startswith("kec/proof.")})


@pytest.mark.parametrize("c,tp,widths", [
    (392, 2, [208, 184]), (584, 2, [304, 280]), (40, 2, [32, 8]),
    (4048, 2, [2032, 2016]), (32, 2, [16, 16]), (40, 3, [16, 16, 8]),
    (40, 4, [16, 16, 8])])
def test_column_split_examples(c, tp, widths):
    assert [b - a for a, b in S.column_split(c, tp)] == widths


@pytest.mark.parametrize("c", COLS)
def test_column_split_covers_every_column_once(c):
    for tp in TPS:
        split = S.column_split(c, tp)
        assert 1 <= len(split) <= tp
        assert split[0][0] == 0 and split[-1][1] == c
        assert all(a < b for a, b in split)  # no empty shard
        assert all(b == a2 for (_, b), (a2, _) in zip(split, split[1:]))
        widths = [b - a for a, b in split]
        assert all(w % P2.RATE == 0 for w in widths[:-1])
        assert all(w == widths[0] for w in widths[:-1])
        assert widths[-1] <= widths[0]
    with pytest.raises(ValueError):
        S.column_split(c, 0)


@pytest.mark.parametrize("c", COLS)
def test_chained_sponge_equals_whole_rows(c):
    rng = np.random.default_rng(c)
    x = F.fp(rng.integers(0, F.P, size=(4, c), dtype=np.int64))
    tree = merkle.commit(x)  # its leaves: P2.hash_rows of whole rows
    for tp in TPS[1:]:
        # the sharded commit chains the plain sponge (a CPU tensor) through
        # the blocks: hash_rows(block, init=state, out_words=24)
        split = S.column_split(c, tp)
        sharded = merkle.commit(tuple(x[:, a:b] for a, b in split))
        assert len(sharded.blocks) == len(split)
        assert all(torch.equal(g, w)
                   for g, w in zip(sharded.levels, tree.levels))
        idx = torch.tensor([3, 0, 2], dtype=torch.int64)
        for got, want in zip(merkle.open_rows(sharded, idx),
                             merkle.open_rows(tree, idx)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("tp", [2, 3])
def test_partial_weighted_sums_add_to_whole(tp):
    rng = np.random.default_rng(tp)
    groups = [F.fp(rng.integers(0, F.P, size=(64, c), dtype=np.int64))
              for c in (40, 392, 24)]  # ctrl, data, accum
    weights = F.fp(rng.integers(0, F.P, size=(456, 8), dtype=np.int64))
    whole = bbmm.bb_weighted_sum_blocks(groups, weights)
    trees = [tuple(g[:, a:b] for a, b in S.column_split(g.shape[1], tp))
             for g in groups[:2]] + [(groups[2],)]
    assert torch.equal(stark._trace_sums(trees, weights), whole)


def test_group_mixing_device_types_raises():
    mesh = M.make_mesh(devices=["cpu", "cuda:0"], dp=1)
    with pytest.raises(ValueError, match="mixes device types"):
        M.shard_batched_prover(prove._AIRS["rv32im"], PO2, prove.TEST_PS,
                               mesh)
    cpu = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="mixes device types"):
        S.ShardedTrace((cpu, torch.zeros((8, 4), dtype=torch.int32,
                                         device="meta")))
    with pytest.raises(ValueError, match="multiple of 16"):
        S.ShardedTrace((cpu[:, :8].contiguous(), cpu))
