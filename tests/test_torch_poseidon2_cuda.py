"""The CUDA Poseidon2 sponge against the plain torch sponge, on the card:
every layout (1, 2, 4 and 8 lanes a hash, and the wrapper's pick), the
tree top and merkle.commit's levels.

Marked `cuda`: the kernel has no CPU mode, so these skip on a host without
an NVIDIA GPU. They import no JAX; run them on a GPU host (which need not
have JAX, hence `--noconftest`) with

    python -m pytest --noconftest tests/test_torch_poseidon2_cuda.py -p no:xdist -o addopts=""
"""

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import merkle as M
from boundless_tpu_torch.core import poseidon2 as P2
from boundless_tpu_torch.kernels import poseidon2 as P2K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sponge has no CPU mode")
    return torch.device("cuda", 0)


def words(shape, seed, dev):
    w = np.random.default_rng(seed).integers(0, F.P, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(w.astype(np.int32)).to(dev)


def hash_lanes(x, lanes):
    """`hash_rows` in a forced layout (lanes a hash)."""
    return P2K._sponge(x, None, P2.DIGEST_WORDS, lanes)


def permute_lanes(states, lanes):
    """`permute` in a forced layout."""
    empty = states.new_empty((states.shape[0], 0))
    return P2K._sponge(empty, states, P2.WIDTH, lanes)


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 127, 1000, 4096])
@pytest.mark.parametrize("cols", [0, 1, 7, 16, 17, 392])
def test_kernel_equals_plain(dev, n, cols, lanes):
    x = words((n, cols), n + cols, dev)
    layout = f"lanes{lanes or P2K.lanes_for(n)}"
    before, by_layout = P2K.LAUNCHES, P2K.LAUNCHES_BY_LAYOUT[layout]
    got = P2K.hash_rows(x) if lanes is None else hash_lanes(x, lanes)
    assert P2K.LAUNCHES == before + 1
    assert P2K.LAUNCHES_BY_LAYOUT[layout] == by_layout + 1
    assert torch.equal(got, P2.hash_rows(x))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_pairs_and_permute(dev, lanes):
    left, right = words((3000, 8), 1, dev), words((3000, 8), 2, dev)
    assert torch.equal(hash_lanes(torch.cat([left, right], 1), lanes),
                       P2.hash_pair(left, right))
    st = words((33, P2.WIDTH), 3, dev)
    assert torch.equal(permute_lanes(st, lanes), P2.permute(st))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_unaligned_rows_take_scalar_loads(dev, lanes):
    x = words((9 * 148 + 1,), 5, dev)[1:].reshape(9, 148)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert torch.equal(hash_lanes(x, lanes), P2.hash_rows(x))


@pytest.mark.parametrize("m", [2, 4, 128, 512, 4096])
def test_tree_top_equals_plain(dev, m):
    level = words((m, 8), m, dev)
    before = P2K.LAUNCHES_BY_LAYOUT["tree_top"]
    got = P2K.hash_tree(level)
    assert P2K.LAUNCHES_BY_LAYOUT["tree_top"] == before + 1
    want = P2.hash_tree(level)
    assert len(got) == len(want) == m.bit_length() - 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,cols", [(1 << 12, 9), (1 << 16, 40)])
def test_commit_levels_equal_plain_loop(dev, n, cols):
    x = words((n, cols), n, dev)
    tree = M.commit(x)
    leaves = P2.hash_rows(x)
    want = [leaves] + P2.hash_tree(leaves)
    assert len(tree.levels) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(tree.levels, want))


def test_wrapper_rejects_bad_inputs(dev):
    x = words((64, 32), 4, dev)
    with pytest.raises(TypeError):
        P2K.hash_rows(x.to(torch.int64))
    with pytest.raises(ValueError):
        P2K.hash_rows(x[:, ::2])
    with pytest.raises(ValueError):
        P2K.hash_rows(x.reshape(-1))
    with pytest.raises(ValueError):
        hash_lanes(x, 3)
    with pytest.raises(ValueError):
        P2K.hash_tree(words((6, 8), 6, dev))
    with pytest.raises(ValueError):
        P2K.hash_tree(words((2 * P2K.tree_max(), 8), 7, dev))
