"""The CUDA NTT and constraint kernels against their plain versions, on the
card (every NTT option; the fused constraint kernel's α-combined columns).

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


@pytest.mark.parametrize("m,rows_in,lanes,inner", [
    (1, 1, 3, 3), (2, 1, 4, 2), (64, 16, 12, 4), (512, 128, 392, 392),
    (NK.MAX_M, 256, 40, 40), (NK.MAX_M, 1024, 33, 3),
    (NK.MAX_M, 1024, 64, 8), (256, 64, 48, 12)])
def test_sub_ntt_options_equal_plain(dev, m, rows_in, lanes, inner):
    """The load zero tail and shift, the store scale and row cut, and the
    transposed store (staged when inner divides W)."""
    x = words((rows_in, lanes), m + lanes, dev)
    q = lanes // inner
    opts = dict(m=m, inner=inner, load=(words((m,), 1, dev),
                                        words((q,), 2, dev)),
                store=(words((m,), 3, dev), words((q,), 4, dev)),
                rows_out=max(1, m // 2))
    for forward in (True, False):
        assert torch.equal(NK.sub_ntt(x, forward, **opts),
                           NK.sub_ntt_plain(x, forward, **opts))
    full = words((m, lanes), lanes, dev)
    mid = words((m, q), 5, dev)
    assert torch.equal(NK.sub_ntt(full, True, mid),
                       NK.sub_ntt_plain(full, True, mid))
    assert NK.blocks_per_sm(m.bit_length() - 1) >= 1


@pytest.mark.parametrize("n,c", [(1 << 12, 3), (1 << 17, 5), (1 << 21, 1)])
def test_four_step_equals_stockham(dev, n, c):
    x = words((n, c), n, dev)
    for forward in (True, False):
        assert torch.equal(NTT.ntt(x, forward), NTT.stockham(x, forward))


@pytest.mark.parametrize("n,c,expand", [(256, 5, 4), (1 << 12, 4, 4),
                                        (1 << 17, 16, 2), (1 << 19, 1, 4)])
def test_fused_glue_equals_plain(dev, n, c, expand):
    x = words((n, c), n + c, dev)
    before = NK.LAUNCHES
    ev = NTT.coset_evaluate(x, expand)
    assert NK.LAUNCHES > before
    assert torch.equal(ev, NTT.coset_evaluate_plain(x, expand))
    assert torch.equal(NTT.coset_interpolate(ev, expand), x)
    assert torch.equal(NTT.intt(ev), NTT.intt_plain(ev))


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
    """The fused kernel's α-combined columns, two classes and one, equal
    `combine_rows` of the plain rows."""
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
    prog = CK.CE.trace(air)
    trans = [bool(z) for z in prog.zclass]
    alpha = F.ext([5, 6, 7, 8], dev)
    for masks in ([trans, [not z for z in trans]], [None]):
        before = CK.LAUNCHES
        got = CK.evaluate_combined(air, *evals, globals_, pub, alpha, masks)
        assert CK.LAUNCHES == before + 1
        want = CK.CE.combine_rows(
            prog.kinds, CK.evaluate_plain(air, *evals, globals_, pub), alpha,
            masks)
        assert len(got) == len(want)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    with pytest.raises(ValueError):
        CK.evaluate_combined(air, evals[0][:, :-1].contiguous(), *evals[1:],
                             globals_, pub, alpha, [None])
    with pytest.raises(ValueError):
        CK.evaluate(air, *evals, globals_, pub)  # rows: CPU only
    assert CK.blocks_per_sm(air) >= 1
