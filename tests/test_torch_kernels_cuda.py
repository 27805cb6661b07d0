"""The CUDA NTT and constraint kernels against their plain versions, on the
card.

Marked `cuda`: the kernels have no CPU mode, so these skip on a host
without an NVIDIA GPU. They import no JAX; run them on a GPU host (which
need not have JAX, hence `--noconftest`) with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -p no:xdist -o addopts=""
"""

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import cons as CK
from boundless_tpu_torch.kernels import ntt as NK
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm import witness as W
from boundless_tpu_torch.zkvm.executor import Executor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def words(shape, seed, dev):
    w = np.random.default_rng(seed).integers(0, F.P, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(w.astype(np.int32)).to(dev)


@pytest.mark.parametrize("m", [1, 2, 16, 256, NK.MAX_M])
@pytest.mark.parametrize("lanes", [1, 15, 17, 392])
def test_sub_ntt_equals_plain(dev, m, lanes):
    x = words((m, lanes), m + lanes, dev)
    for forward in (True, False):
        before = NK.LAUNCHES
        got = NK.sub_ntt(x, forward)
        assert NK.LAUNCHES == before + 1
        assert torch.equal(got, NTT.stockham(x, forward))
    mid = words((m, 1 if lanes % 3 else 3), lanes, dev)
    assert torch.equal(NK.sub_ntt(x, True, mid),
                       NK.sub_ntt_plain(x, True, mid))


@pytest.mark.parametrize("n,c", [(1 << 12, 3), (1 << 17, 5), (1 << 21, 1)])
def test_four_step_equals_stockham(dev, n, c):
    x = words((n, c), n, dev)
    for forward in (True, False):
        assert torch.equal(NTT.ntt(x, forward), NTT.stockham(x, forward))


def test_ntt_wrapper_rejects_bad_inputs(dev):
    x = words((64, 8), 1, dev)
    with pytest.raises(TypeError):
        NK.sub_ntt(x.to(torch.int64), True)
    with pytest.raises(ValueError):
        NK.sub_ntt(x[:, ::2], True)
    with pytest.raises(ValueError):
        NK.sub_ntt(words((2 * NK.MAX_M, 1), 2, dev), True)
    with pytest.raises(ValueError):
        NK.sub_ntt(x, True, words((64, 3), 3, dev))


@pytest.mark.parametrize("variant", ["rv32i", "rv32im"])
def test_constraint_kernel_equals_plain(dev, variant):
    po2 = 6
    image = guests.loop_guest()
    seg = Executor(image, guests.words([3]), segment_po2=po2).run().segments[0]
    w = W.trace_segment(image, seg, po2, rng=np.random.default_rng(1))
    air = prove._AIRS[variant]
    data = F.fp(W.data_for_variant(w.data, variant), dev)
    ctrl = F.fp(w.ctrl, dev)
    globals_ = F.ext(np.arange(8).reshape(2, 4) + 3, dev)
    accum = air.accum_trace(ctrl, data, globals_)
    evals = [NTT.coset_evaluate(NTT.interpolate(x)).contiguous()
             for x in (ctrl, data, accum)]
    pub = W.to_public_values(w.pub, dev)
    before = CK.LAUNCHES
    got = CK.evaluate(air, *evals, globals_, pub)
    assert CK.LAUNCHES == before + len(CK.chunks(CK.CE.trace(air)))
    assert torch.equal(got, CK.evaluate_plain(air, *evals, globals_, pub))
    with pytest.raises(ValueError):
        CK.evaluate(air, evals[0][:, :-1].contiguous(), *evals[1:], globals_,
                    pub)
