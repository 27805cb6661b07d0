"""The p254 sponge and the BN254 MSM kernels against their plain versions,
on the card: every sponge layout (one thread, 3 lanes, the tree top, the
path walk) bit for bit, and the MSM's signed digits on their edge cases.

Marked `cuda`: the kernels have no CPU mode, so these skip on a host
without an NVIDIA GPU. They import no JAX; run them on a GPU host with

    python -m pytest --noconftest tests/test_torch_bn254_cuda.py -p no:xdist -o addopts=""
"""

import random

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import merkle, poseidon_bn254 as P254, suites
from boundless_tpu_torch.groth16 import msm as HM
from boundless_tpu_torch.groth16 import msm_device as MD
from boundless_tpu_torch.groth16.bn254 import G1, R
from boundless_tpu_torch.kernels import msm as MK
from boundless_tpu_torch.kernels import poseidon254 as P254K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def words(shape, seed):
    w = np.random.default_rng(seed).integers(0, F.P, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(w.astype(np.int32))


def same(got, want):
    np.testing.assert_array_equal(P254K.words_np(got), P254K.words_np(want))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("n,cols", [(1, 0), (7, 17), (31, 48), (129, 64),
                                    (300, 16)])
def test_rows_equal_plain_in_each_layout(dev, lanes, n, cols):
    x = words((n, cols), n + cols)
    same(P254K._hash_rows(x.to(dev), lanes), P254K.hash_rows(x))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("m", [1, 11, 200])
def test_pairs_equal_plain_in_each_layout(dev, lanes, m):
    d = P254K.hash_rows(words((2 * m, 3), m)).view(m, 16)
    same(P254K._hash_level(d.to(dev), lanes), P254K.hash_level(d))


@pytest.mark.parametrize("m", [2, 4, 64, P254K.TREE_TOP])
def test_tree_top_equals_the_level_loop(dev, m):
    level = P254K.hash_rows(words((m, 5), m))
    got = P254K.hash_tree(level.to(dev))
    want = P254K.hash_tree(level)
    assert len(got) == len(want) == m.bit_length() - 1
    for g, w in zip(got, want):
        same(g, w)


def test_commit_and_path_walk_equal_plain(dev):
    x = words((1 << 9, 24), 3)
    suite = suites.get("poseidon254")
    tree, ref = suite.commit(x.to(dev)), suite.commit(x)
    for g, w in zip(tree.levels, ref.levels):
        same(g, w)
    idx = torch.tensor([0, 5, 77, 511], dtype=torch.int64)
    rows, paths = merkle.open_rows(ref, idx)
    leaves = P254K.hash_rows(rows)
    same(P254K.hash_paths(leaves.to(dev), idx.to(dev), paths.to(dev)),
         P254K.hash_paths(leaves, idx, paths))
    ok = suite.verify_rows(tree.root, idx.to(dev), rows.to(dev), paths.to(dev))
    assert ok.tolist() == [True] * 4
    bad = paths.clone()
    bad[2, 4, 0] ^= 1
    ok = suite.verify_rows(tree.root, idx.to(dev), rows.to(dev), bad.to(dev))
    assert ok.tolist() == [True, True, False, True]
    w = P254K.words_np(paths[1, 3])
    x_r = sum(int(v) << (32 * k) for k, v in enumerate(w)) + P254.FR
    bad = paths.clone()
    bad[1, 3] = P254K.words_tensor(
        [(x_r >> (32 * k)) & 0xFFFFFFFF for k in range(8)], "cpu")
    with pytest.raises(ValueError, match="out of field range"):
        suite.verify_rows(tree.root, idx.to(dev), rows.to(dev), bad.to(dev))


def signed_edge_case_msm(n=300, seed=5):
    """Scalars 0, 1, r - 1, digits of exactly 128 and -127, a point and its
    negation in one bucket (P + -P), a point added twice (P + P), the
    point at infinity."""
    rng = random.Random(seed)
    g = G1.generator()
    points = [g.mul(rng.randrange(1, 10**6)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
    scalars[3] = int.from_bytes(bytes([0x80] * 31), "little")  # digits 128
    scalars[4] = int.from_bytes(bytes([0x81] * 31), "little")  # -127 + carry
    points[5] = G1.infinity()
    points[6], scalars[6] = points[7].neg(), scalars[7]  # -P, same digits
    points[8], scalars[8] = points[9], R - scalars[9]  # P, negated digits
    points[10], scalars[10] = points[11], scalars[11]  # P + P
    return points, scalars


def test_msm_equals_plain_and_host(dev):
    points, scalars = signed_edge_case_msm()
    pts = MD.device_points(points, dev)
    pr = MD.prep(scalars, dev)
    got = MD.point_from_words(MK.pippenger(pts, pr).cpu().numpy())
    want = MD.point_from_words(MD.plain_pippenger(pts, pr).cpu().numpy())
    assert got.eq(want)
    assert got.eq(HM.msm_pippenger(points, scalars))


def test_msm_small_cases(dev):
    g = G1.generator()
    a = g.mul(12345)
    assert MD.msm([a, G1.infinity()], [0, 12345], dev).is_infinity()
    assert MD.msm([g, g], [1, R - 1], dev).is_infinity()
    assert MD.msm([g, g.neg()], [9, 9], dev).is_infinity()
    assert MD.msm([a], [R + 3], dev).eq(a.mul(3))
    assert MD.msm([g] * 70, [0x80] * 70, dev).eq(g.mul(0x80 * 70))
