"""The trace upload's kernel (`csrc/upload.cu`) on the card, against
`field.fp` on the host (tolerance 0: field words).

A seeded (2^20, 576) int64 array over the whole int64 range, the po2-20
witness's shape, uploaded whole, as its 392 rv32i columns read in place
(and its first 2^17 rows so, the po2-17 witness's) and as a contiguous
(2^20, 64) copy, a recursion data trace's shape: word-equal to `fp`, one
launch a staging block. A po2-12 segment proof whose witness went up
through the kernel equals, word for word, the proof of the same witness
uploaded by `fp` on the host.

Marked `cuda`: the kernel has no CPU mode, so these skip on a host without
an NVIDIA GPU (the CUDA source's CPU checks are tests/test_torch_upload.py).
They import no JAX; run them on a GPU host with

    python -m pytest --noconftest tests/test_torch_upload_cuda.py -p no:xdist -o addopts=""
"""

import numpy as np
import pytest
import torch

from boundless_tpu_torch import convert
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.kernels import upload as UK
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upload kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def witness_shaped():
    i64 = np.iinfo(np.int64)
    a = np.random.default_rng(20).integers(i64.min, i64.max,
                                           size=(1 << 20, 576),
                                           dtype=np.int64, endpoint=True)
    a[:3] %= 4 * F.P  # canonical-sized words beside the full range
    a[3, :4] = [i64.min, i64.max, -1, -F.P]
    return a


@pytest.mark.parametrize("rows,cols", [
    pytest.param(1 << 20, 576, id="576"),
    pytest.param(1 << 20, 392, id="392"),  # po2 20's rv32i columns in place
    pytest.param(1 << 20, 64, id="64"),  # a rec_po2-20 data trace
    pytest.param(1 << 17, 392, id="po2_17_392"),  # po2 17's in place
])
def test_upload_is_word_equal_to_fp_at_the_witness_shape(dev, witness_shaped,
                                                         rows, cols):
    words = witness_shaped[:rows, :cols]
    if cols == 64:  # the recursion's data trace lies contiguous
        words = np.ascontiguousarray(words)
    blocks = -(-rows // UK.block_rows(cols))
    before = UK.LAUNCHES
    got = F.upload(words, dev)
    torch.cuda.synchronize()
    assert UK.LAUNCHES == before + blocks
    assert got.device == dev and got.shape == (rows, cols)
    want = torch.from_numpy(F.mont_np(words).astype(np.int32))
    assert torch.equal(got.cpu(), want)


def test_a_proof_uploaded_on_the_card_equals_the_host_route(dev,
                                                            monkeypatch):
    po2 = 12
    image = guests.loop_guest()
    seg = Executor(image, guests.words([((1 << po2) - 40) // 2]),
                   segment_po2=po2).run().segments[0]

    def proof():
        r = prove.prove_segment(image, seg, prove.TEST_PS, device=dev,
                                rng=np.random.default_rng(12))
        return convert.proof_to_numpy(r.proof)

    before = UK.LAUNCHES
    card = proof()
    assert UK.LAUNCHES > before
    monkeypatch.setattr(F, "upload", lambda words, device: F.fp(words,
                                                                device))
    before = UK.LAUNCHES
    host = proof()
    assert UK.LAUNCHES == before
    assert sorted(card) == sorted(host)
    for k in host:
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
