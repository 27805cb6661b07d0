"""The trace upload (`core/field.upload` -> `kernels/upload.py` ->
`csrc/upload.cu`) on the CPU.

`csrc/upload.cu` built by g++ against `tests/cuda_emu.h` (emulated threads;
a copy is a memcpy, counted with its bytes) on host memory, word for word
against `field.fp` (tolerance 0): int64 edge values (0, P - 1, P, 2^31,
2^32, 2^62, -1, -P, the int64 extremes and their neighbours) and random
words over the whole int64 range, the witness's 392 of 576 columns read in
place, 0 and 1 rows, rows not a multiple of the staging block, the
recursion's (n, 64) words; each staging block one launch and one 2-D copy
of its rows' words. The wrapper's host side: which arrays are read
in place and which are converted first, the staging block's size, its
refusal of a CPU device. `field.upload`'s routes: a CPU device converts on
the host (`fp`, span attr `route="host"`, no launch), a CUDA device hands
the array as it lies to the kernel's wrapper (`route="card"`). The card
itself: tests/test_torch_upload_cuda.py.
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.kernels import upload as UK
from boundless_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_emu_build  # noqa: E402

P = F.P
I64 = np.iinfo(np.int64)
EDGES = [0, 1, P - 1, P, P + 1, 2 * P, 3 * P - 1, 2**31 - 1, 2**31,
         2**32 - 1, 2**32, 2**32 + 1, 2**62, 2**63 - P, -1, -2, -P, -P - 1,
         -(2**31), -(2**32), -(2**62), I64.min, I64.min + 1, I64.max,
         I64.max - 1]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = cuda_emu_build.build("upload.cu", tmp_path_factory.mktemp("emuup"))
    UK.typed(lib)
    lib.emu_copies.argtypes = [ctypes.c_void_p]
    return lib


def copies(lib):
    out = np.zeros(2, np.int64)
    lib.emu_copies(out.ctypes.data)
    return int(out[0]), int(out[1])


def run_emulated(lib, words, rows_a_block=None):
    """csrc/upload.cu on host memory through the wrapper's `convert`:
    `words` as `host_rows` gives them, `rows_a_block` rows a staging block
    (default the wrapper's). -> (out, launches, copies, bytes copied)."""
    a = UK.host_rows(words)
    rows, cols = a.shape
    ld = UK.pitch(a)
    n = rows_a_block or max(1, min(UK.block_rows(cols), rows))
    out = torch.full((rows, cols), -1, dtype=torch.int32)
    stage = torch.empty(2 * n * cols, dtype=torch.int64)
    c0, b0 = copies(lib)
    launched = UK.convert(lib, a, out, stage, n, None)
    c1, b1 = copies(lib)
    return out, launched, c1 - c0, b1 - b0


def full_range(rng, shape):
    return rng.integers(I64.min, I64.max, size=shape, dtype=np.int64,
                        endpoint=True)


def case_words(case):
    """(words, rows a staging block or None) of an emulated case."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "edges":
        w = full_range(rng, (len(EDGES), 33))
        w[:, 0] = EDGES
        w[0, 1:len(EDGES) + 1] = EDGES
        return w, None
    if case == "random_full_range":
        return full_range(rng, (70, 45)), 16
    if case == "witness_392_of_576":
        return full_range(rng, (40, 576))[:, :392], 6
    if case == "rows_0":
        return np.zeros((0, 392), np.int64), None
    if case == "rows_1":
        return full_range(rng, (1, 392)), None
    if case == "rows_not_a_multiple":
        return full_range(rng, (23, 20)), 5
    if case == "recursion_n_64":
        return full_range(rng, (300, 64)), 64
    raise KeyError(case)


CASES = ["edges", "random_full_range", "witness_392_of_576", "rows_0",
         "rows_1", "rows_not_a_multiple", "recursion_n_64"]


@pytest.mark.parametrize("case", CASES)
def test_cuda_source_is_word_equal_to_fp(emulated, case):
    words, n = case_words(case)
    out, launched, copied, nbytes = run_emulated(emulated, words, n)
    assert torch.equal(out, F.fp(words))
    rows, cols = words.shape
    n = n or max(1, rows)
    assert launched == copied == -(-rows // n)
    assert nbytes == rows * cols * 8


def test_cuda_source_refuses_what_the_pipeline_does_not_take(emulated):
    a = np.zeros((4, 6), np.int64)
    out = np.zeros((4, 6), np.int32)
    stage = np.zeros(2 * 12, np.int64)
    n = ctypes.c_longlong(0)
    call = (lambda rows, cols, ld, block, words: emulated.bt_upload(
        a.ctypes.data, rows, cols, ld, block, stage.ctypes.data, words,
        out.ctypes.data, None, ctypes.byref(n)))
    assert call(4, 6, 6, 2, 12) == 0 and n.value == 2
    for args in [(4, 6, 5, 2, 12),    # a pitch below the columns
                 (4, 6, 6, 3, 12),    # a block past its buffer
                 (4, 6, 6, 0, 12),    # no rows a block
                 (-1, 6, 6, 2, 12)]:  # rows below 0
        assert call(*args) == 1 and n.value == 0, args


# -- the wrapper's host side ------------------------------------------------


def test_the_witness_columns_are_read_in_place():
    data = np.zeros((16, 576), np.int64)
    view = data[:, :392]
    a = UK.host_rows(view)
    assert a.shape == (16, 392) and np.shares_memory(a, data)
    assert a.ctypes.data == data.ctypes.data and UK.pitch(a) == 576
    for inplace in (data, data[3:9, 100:492], data[::2], data[:1, 5:]):
        assert np.shares_memory(UK.host_rows(inplace), data)


@pytest.mark.parametrize("words,shape", [
    (np.arange(12, dtype=np.uint32).reshape(3, 4), (3, 4)),  # other dtype
    ([[1, -2], [3, 4]], (2, 2)),                             # a list
    (np.zeros((5, 6), np.int64).T, (6, 5)),                  # transposed
    (np.zeros((5, 6), np.int64)[::-1], (5, 6)),              # rows reversed
    (np.zeros((5, 6), np.int64)[:, ::2], (5, 3)),            # a column step
    (np.zeros((2, 3, 4), np.int64), (6, 4)),                 # 3-D
    (np.int64(7), (1, 1)),                                   # a scalar
])
def test_other_arrays_are_converted_first(words, shape):
    a = UK.host_rows(words)
    assert a.dtype == np.int64 and a.shape == shape
    assert a.strides[1] == 8 and UK.pitch(a) >= shape[1]
    np.testing.assert_array_equal(a, np.asarray(words).reshape(shape))


def test_staging_blocks_fit_their_buffers():
    for cols in (392, 584, 64, 1, 4048, 1 << 24):
        n = UK.block_rows(cols)
        assert n >= 1
        assert n == 1 or n * cols * 8 <= UK.STAGE_BYTES
        assert (n + 1) * cols * 8 > UK.STAGE_BYTES
    # the witness: 21,399 rows a block, 50 blocks at po2 20, 128 MiB staged
    assert UK.block_rows(392) == 21399
    assert -(-(1 << 20) // UK.block_rows(392)) == 50
    assert 2 * UK.STAGE_BYTES <= 256 << 20


def test_the_kernel_wrapper_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA"):
        UK.upload(np.zeros((2, 2), np.int64), "cpu")


# -- field.upload's routes ----------------------------------------------------


@pytest.fixture
def tracing():
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()


def last_upload_span():
    return [r for r in profiling.records() if r["name"] == "upload"][-1]


@pytest.mark.parametrize("view", [False, True])
def test_a_cpu_upload_converts_on_the_host(tracing, view):
    words = full_range(np.random.default_rng(3), (50, 576))
    words[0, :len(EDGES)] = EDGES
    if view:
        words = words[:, :392]
    launches = UK.LAUNCHES
    got = F.upload(words, "cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert torch.equal(got, F.fp(words, "cpu"))
    assert UK.LAUNCHES == launches
    assert last_upload_span()["attrs"] == {"route": "host"}


def test_a_cuda_upload_hands_the_array_as_it_lies_to_the_kernel(
        tracing, monkeypatch):
    seen = []

    def kernel(words, device):
        seen.append((words, torch.device(device)))
        return F.fp(words, "cpu")

    monkeypatch.setattr(UK, "upload", kernel)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    data = np.zeros((8, 576), np.int64)
    view = data[:, :392]
    F.upload(view, "cuda")
    F.upload(view, torch.device("cuda", 0))
    assert [w is view for w, _ in seen] == [True, True]
    assert [d.type for _, d in seen] == ["cuda", "cuda"]
    assert last_upload_span()["attrs"] == {"route": "card"}
