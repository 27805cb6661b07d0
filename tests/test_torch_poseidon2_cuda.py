"""The CUDA Poseidon2 sponge against the plain torch sponge, on the card.

Marked `cuda`: the kernel has no CPU mode, so these skip on a host without
an NVIDIA GPU. They import no JAX; run them on a GPU host (which need not
have JAX, hence `--noconftest`) with

    python -m pytest --noconftest tests/test_torch_poseidon2_cuda.py -p no:xdist -o addopts=""
"""

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import field as F
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


@pytest.mark.parametrize("n", [1, 127, 1000, 4096])
@pytest.mark.parametrize("cols", [0, 1, 7, 16, 17, 392])
def test_kernel_equals_plain(dev, n, cols):
    x = words((n, cols), n + cols, dev)
    before = P2K.LAUNCHES
    got = P2K.hash_rows(x)
    assert P2K.LAUNCHES == before + 1
    assert torch.equal(got, P2.hash_rows(x))


def test_pairs_and_permute(dev):
    left, right = words((3000, 8), 1, dev), words((3000, 8), 2, dev)
    assert torch.equal(P2K.hash_pairs(left, right), P2.hash_pair(left, right))
    st = words((33, P2.WIDTH), 3, dev)
    assert torch.equal(P2K.permute(st), P2.permute(st))


def test_wrapper_rejects_bad_inputs(dev):
    x = words((64, 32), 4, dev)
    with pytest.raises(TypeError):
        P2K.hash_rows(x.to(torch.int64))
    with pytest.raises(ValueError):
        P2K.hash_rows(x[:, ::2])
    with pytest.raises(ValueError):
        P2K.hash_rows(x.reshape(-1))
