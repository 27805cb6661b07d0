"""Port parity: Poseidon2 constants, permutation, plain sponge and Merkle.

The port's plain `hash_rows` is held against the JAX reference's Pallas
sponge in interpret mode (the v2 layout, N % 1024 == 0, here; the v1
layout in test_torch_poseidon2_v1_*.py) and against `P2.hash_elems`.
Exact equality throughout (field elements)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import merkle as JM
from boundless_tpu.core import poseidon2 as JP2
from boundless_tpu.core import poseidon2_np as JP2NP
from boundless_tpu.core import poseidon2_pallas as JP2K
from boundless_tpu_torch import convert
from boundless_tpu_torch.core import merkle as M
from boundless_tpu_torch.core import poseidon2 as P2
from boundless_tpu_torch.core import poseidon2_np as P2NP
from boundless_tpu_torch.kernels import poseidon2 as P2K

SPONGE_COLS = [0, 5, 16, 40]


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def test_constants_equal_reference():
    for port, ref in zip(convert.poseidon2_constants(), JP2._constants()):
        np.testing.assert_array_equal(port, np.asarray(ref))
    assert P2.DIAG_SPEC == JP2.DIAG_SPEC


def test_permute():
    st = words((64, P2.WIDTH), 1)
    st[0] = 0
    same(P2.permute(t(st)), JP2.permute(j(st)))


@pytest.mark.parametrize("cols", SPONGE_COLS + [1, 33])
def test_hash_rows_equals_hash_elems(cols):
    x = words((20, cols), cols)
    same(P2.hash_rows(t(x)), JP2.hash_elems(j(x)))


@pytest.mark.parametrize("cols", SPONGE_COLS)
def test_hash_rows_equals_pallas_v2(cols):
    x = words((JP2K.TILE_V2, cols), 100 + cols)
    same(P2.hash_rows(t(x)), JP2K.hash_rows(j(x), interpret=True))


def test_hash_pairs_equals_pallas_v2():
    left, right = words((JP2K.TILE_V2, 8), 5), words((JP2K.TILE_V2, 8), 6)
    same(P2K.hash_pairs(t(left), t(right)),
         JP2K.hash_pairs(j(left), j(right), interpret=True))
    same(P2.hash_pair(t(left), t(right)), JP2.hash_pair(j(left), j(right)))


def test_init_state_sponge_is_one_permutation():
    st = words((9, P2.WIDTH), 7)
    got = P2.hash_rows(torch.zeros((9, 0), dtype=torch.int32), init=t(st),
                       out_words=P2.WIDTH)
    same(got, JP2.permute(j(st)))


def test_cpu_wrapper_takes_plain_version():
    before = P2K.LAUNCHES
    x = words((17, 21), 8)
    same(P2K.hash_rows(t(x)), JP2.hash_elems(j(x)))
    st = words((3, P2.WIDTH), 9)
    same(P2K.permute(t(st)), JP2.permute(j(st)))
    assert P2K.LAUNCHES == before  # no kernel launched for CPU tensors


def test_poseidon2_np_parity():
    elems = list(range(1, 40))
    assert P2NP.hash_elems_np(elems) == JP2NP.hash_elems_np(elems)
    st = words((5, P2.WIDTH), 10)
    np.testing.assert_array_equal(P2NP.permute_np(st), JP2NP.permute_np(st))


@pytest.mark.parametrize("n,cols", [(1, 3), (16, 40), (64, 9)])
def test_merkle_commit_open_verify(n, cols):
    x = words((n, cols), n)
    tree = M.commit(t(x))
    jtree = JM.commit(j(x))
    for lvl, jlvl in zip(tree.levels, jtree.levels):
        same(lvl, jlvl)
    assert tree.num_leaves == jtree.num_leaves == n
    idx = np.array([0, n - 1, n // 2, 0], dtype=np.int64) % n
    rows, paths = M.open_rows(tree, torch.from_numpy(idx))
    jrows, jpaths = JM.open_rows(jtree, jnp.asarray(idx.astype(np.int32)))
    same(rows, jrows)
    same(paths, jpaths)
    ok = M.verify_rows(tree.root, torch.from_numpy(idx), rows, paths)
    assert bool(ok.all())
    bad = rows.clone()
    bad[1, 0] = (bad[1, 0] + 1) % JF.P
    ok = M.verify_rows(tree.root, torch.from_numpy(idx), bad, paths)
    assert not bool(ok[1]) and bool(ok[0])
