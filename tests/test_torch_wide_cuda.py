"""The data-LDE path's kernels on the card at the widest tile the port
makes: an rv32im segment of po2 20, whose data LDE is 2^22 x 584 int32
words (2,449,473,536 words, 9.8 GB, past 2^31), and its witness's
full-width int64 upload, 2^20 x 584.

Each kernel against its plain route on the card, on sampled columns or
rows (tolerance 0: field words): the NTT sub-transform on a (1024,
2392064) tile, the four-step LDE (`coset_evaluate`, three launches of
2^31.19 words each) and its inverse back to the coefficients, the sponge's
leaves, the weighted sum of the DEEP combination (W = 8), and the upload
against `field.fp`. Sampled rows include the last ones, whose offsets lie
past 2^31 (and past 2^32 in the upload's int64 staging).

Marked `cuda`: the kernels have no CPU mode, so these skip on a host
without an NVIDIA GPU (their shape checks on the CPU are
tests/test_torch_wide.py). They need about 40 GB of the card and 10 GB of
host memory, and import no JAX; run them on a GPU host with

    python -m pytest --noconftest tests/test_torch_wide_cuda.py -p no:xdist -o addopts=""
"""

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import bbmm
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.core import poseidon2 as P2
from boundless_tpu_torch.kernels import ntt as NK
from boundless_tpu_torch.kernels import poseidon2 as P2K
from boundless_tpu_torch.kernels import upload as UK

pytestmark = pytest.mark.cuda

PO2 = 20
ROWS = 4 << PO2
COLS = 584  # rv32im's data columns, and its witness's width
SAMPLES = 48


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tile(dev):
    """A seeded (2^22, 584) tile of Montgomery words, on the card."""
    gen = torch.Generator(device=dev).manual_seed(20)
    t = torch.randint(0, F.P, (ROWS, COLS), generator=gen, device=dev,
                      dtype=torch.int32)
    yield t
    del t
    torch.cuda.empty_cache()


def _sample(n: int, seed: int) -> torch.Tensor:
    """SAMPLES indices below n: the first, the last few, the rest drawn."""
    rng = np.random.default_rng(seed)
    picked = {0, 1, n - 1, n - 2, n - 3} | set(
        int(i) for i in rng.choice(n, SAMPLES, replace=False))
    return torch.tensor(sorted(picked))


def test_the_tile_is_past_2_31_words(tile):
    assert tile.numel() == 2_449_473_536 > 1 << 31


def test_sub_transform_of_a_tile_past_2_31_words(dev, tile):
    x = tile.view(NK.MAX_M, -1)  # (1024, 2392064): the LDE's leading shape
    y = NK.sub_ntt(x, True)
    cols = _sample(x.shape[1], 1).to(dev)
    want = NK.sub_ntt_plain(x[:, cols].contiguous(), True)
    assert torch.equal(y[:, cols], want)
    del y
    torch.cuda.empty_cache()


def test_four_step_lde_of_the_wide_trace_and_back(dev, tile):
    coeffs = tile[: 1 << PO2]
    before = NK.LAUNCHES
    evals = NTT.coset_evaluate(coeffs, expand=4)
    assert NK.LAUNCHES - before == 3  # 1024 x 64 x 64, each 2^31.19 words
    assert evals.shape == (ROWS, COLS)
    cols = _sample(COLS, 2).to(dev)
    want = NTT.coset_evaluate_plain(coeffs[:, cols].contiguous(), 4)
    assert torch.equal(evals[:, cols], want)
    back = NTT.coset_interpolate(evals, expand=4)
    assert torch.equal(back, coeffs)
    del evals, back, want
    torch.cuda.empty_cache()


def test_sponge_leaves_of_the_wide_lde(dev, tile):
    before = P2K.LAUNCHES_BY_LAYOUT["lanes1"]
    leaves = P2K.hash_rows(tile)
    assert P2K.LAUNCHES_BY_LAYOUT["lanes1"] == before + 1
    rows = _sample(ROWS, 3).to(dev)
    assert torch.equal(leaves[rows], P2.hash_rows(tile[rows]))


def test_weighted_sum_over_the_wide_lde(dev, tile):
    gen = torch.Generator(device=dev).manual_seed(21)
    weights = torch.randint(0, F.P, (COLS, 8), generator=gen, device=dev,
                            dtype=torch.int32)
    got = bbmm.bb_weighted_sum(tile, weights)
    rows = _sample(ROWS, 4).to(dev)
    assert torch.equal(got[rows],
                       bbmm.bb_weighted_sum_plain(tile[rows], weights))


def test_full_width_upload_of_the_wide_witness(dev):
    rng = np.random.default_rng(22)
    words = rng.integers(0, F.P, size=(1 << PO2, COLS), dtype=np.int64)
    words[-1, :4] = [-1, np.iinfo(np.int64).max, np.iinfo(np.int64).min, F.P]
    before = UK.LAUNCHES
    got = UK.upload(words, dev)
    assert UK.LAUNCHES - before == -(-(1 << PO2) // UK.block_rows(COLS))
    rows = _sample(1 << PO2, 5)
    assert torch.equal(got[rows.to(dev)].cpu(), F.fp(words[rows.numpy()],
                                                    "cpu"))
