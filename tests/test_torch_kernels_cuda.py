"""The CUDA NTT, constraint and weighted-sum kernels against their plain
versions, on the card (every NTT option; the fused constraint kernel's
α-combined columns; the weighted sum with row strides, edge shapes and
both widths it takes, W = 4 and 8, K split over blocks, column-block
tables and the α-combine through them, and its refusals: any other width,
and the transposed view that `bb_weighted_sum_t` passes; the int8
tensor-core product and ldmatrix wrappers of `csrc/ptx.cuh` against a
numpy u8 product).

Marked `cuda`: the kernels have no CPU mode, so these skip on a host
without an NVIDIA GPU. They import no JAX; run them on a GPU host (which
need not have JAX, hence `--noconftest`) with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -p no:xdist -o addopts=""
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import bbmm as B
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import bbmm as BK
from boundless_tpu_torch.kernels import cons as CK
from boundless_tpu_torch.kernels import build
from boundless_tpu_torch.kernels import ntt as NK
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm import witness as W
from boundless_tpu_torch.zkvm.executor import Executor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mma_probe import MMA_PROBE, mma_case  # noqa: E402

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


@pytest.mark.parametrize("m,k,w,pad", [
    (1, 1, 4, 0), (129, 1000, 8, 3), (1000, 33, 4, 5), (300, 16, 4, 0),
    (1 << 16, 480, 8, 0), (1 << 12, 8112, 4, 0)])
def test_weighted_sum_equals_plain(dev, m, k, w, pad):
    host = words((m, k + pad), m, dev)
    wt = words((k, w), k, dev)
    before = BK.LAUNCHES
    got = B.bb_weighted_sum(host[:, pad:], wt)  # row stride K + pad
    want = B.bb_weighted_sum_plain(host[:, pad:], wt)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert BK.LAUNCHES == before + BK.launches_of(m, k, sms)  # 2: K split
    assert torch.equal(got, want)


def test_weighted_sum_worst_case_and_refusals(dev):
    full = torch.full((300, 8112), F.P - 1, dtype=torch.int32, device=dev)
    wt = torch.full((8112, 8), F.P - 1, dtype=torch.int32, device=dev)
    assert torch.equal(B.bb_weighted_sum(full, wt),
                       B.bb_weighted_sum_plain(full, wt))
    with pytest.raises(ValueError):
        B.bb_weighted_sum(full[::2, ::2], wt[::2])  # no unit stride
    with pytest.raises(TypeError):
        B.bb_weighted_sum(full.to(torch.int64), wt)
    with pytest.raises(ValueError):
        B.bb_weighted_sum(full, wt[:-1])
    with pytest.raises(ValueError):
        B.bb_weighted_sum(full, wt[:, :3].contiguous())  # W not 4 or 8
    with pytest.raises(ValueError):
        B.bb_weighted_sum(full, wt[:, :4])  # strided weights
    with pytest.raises(ValueError):  # a (K, M) matrix: no transposed kernel
        B.bb_weighted_sum_t(full, wt[:300])


@pytest.mark.parametrize("variant", ["rv32i", "rv32im"])
def test_constraint_kernel_equals_plain(dev, variant):
    """The fused kernel's α-combined columns, two classes and one, equal
    `combine_rows` of the plain rows, every weighted sum in them (the
    LogUp groups, the combine) the plain one."""
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
        ws_before = BK.LAUNCHES
        with pytest.MonkeyPatch.context() as mp:  # plain weighted sums
            mp.setattr(B, "bb_weighted_sum", B.bb_weighted_sum_plain)
            mp.setattr(B, "bb_weighted_sum_t", B.bb_weighted_sum_t_plain)
            want = CK.CE.combine_rows(
                prog.kinds, CK.evaluate_plain(air, *evals, globals_, pub),
                alpha, masks)
        assert BK.LAUNCHES == ws_before  # the reference launches no kernel
        assert len(got) == len(want)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    with pytest.raises(ValueError):
        CK.evaluate_combined(air, evals[0][:, :-1].contiguous(), *evals[1:],
                             globals_, pub, alpha, [None])
    with pytest.raises(ValueError):
        CK.evaluate(air, *evals, globals_, pub)  # rows: CPU only
    assert CK.blocks_per_sm(air) >= 1


def test_mma_probe_equals_numpy_u8_product(dev):
    """The u8 product and ldmatrix as the hardware lays out their
    fragments (`csrc/ptx.cuh`, through tests/mma_probe.py) against numpy."""
    lib = build.load_source("bt_mma_probe", lambda: MMA_PROBE)
    lib.bt_mma_probe.argtypes = [ctypes.c_void_p] * 6
    for seed in range(3):
        a, b, c, want = mma_case(seed)
        ta, tb, tc = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in (a, b.T, c))
        d, e = (torch.zeros((16, 8), dtype=torch.int32, device=dev)
                for _ in range(2))
        assert lib.bt_mma_probe(ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
                                d.data_ptr(), e.data_ptr(), None) == 0
        torch.cuda.synchronize()
        np.testing.assert_array_equal(d.cpu().numpy(), want)
        np.testing.assert_array_equal(e.cpu().numpy(), want)


def test_weighted_sum_blocks_and_split_equal_plain(dev):
    """A column-block table (a VecVal read from inside a wider matrix, a
    base column of it, a VecVal, a broadcast constant, an ext item) through
    the α-combine in one launch, and calls that split K (two launches),
    against the plain version."""
    m = 5000
    big = words((m, 12), 1, dev)
    cons = [stark.VecVal(big[:, 2:7]), big[:, 9],
            stark.ExtVal(words((m, 4), 2, dev)),
            stark.VecVal(words((m, 3), 3, dev)), words((1,), 4, dev)]
    sizes = [5, 1, 1, 3, 1]
    apows = NTT.ext_powers(words((4,), 5, dev), sum(sizes))
    before = BK.LAUNCHES
    got = stark._combine_pointwise(cons, sizes, apows)
    assert BK.LAUNCHES == before + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stark.bbmm, "bb_weighted_sum_blocks",
                   B.bb_weighted_sum_blocks_plain)
        assert torch.equal(got, stark._combine_pointwise(cons, sizes, apows))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, k, w in ((100, 480, 4), (192, 480, 8), (1 << 12, 8112, 4)):
        v, wt = words((m, k), m, dev), words((k, w), k, dev)
        before = BK.LAUNCHES
        got = B.bb_weighted_sum(v, wt)
        assert BK.LAUNCHES == before + BK.launches_of(m, k, sms) == before + 2
        assert torch.equal(got, B.bb_weighted_sum_plain(v, wt)), (m, k, w)
