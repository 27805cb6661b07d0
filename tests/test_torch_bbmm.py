"""Port parity: the exact weighted sums against JAX's int8-limb MXU sums
(`core/bbmm.py`), bit for bit (tolerance 0).

The plain version (CPU tensors) against JAX, with many chunks and
transposed; the dispatch (a CPU tensor runs the plain version and
launches nothing; the kernel's wrapper refuses CPU tensors, reads
row-major views in place and refuses transposed ones); `csrc/bbmm.cu`
built by g++ against `tests/cuda_emu.h` (emulated threads) on host
memory, against JAX `bb_weighted_sum`: K over several tiles, M = 1 and M
not a multiple of the block, W = 4 and 8 (any other width refused), row
strides past the matrix, and every word P - 1 at K = 8,112. A
`cuda`-marked case holds the kernel to its plain version on the card and
skips here.
"""

import ctypes
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import bbmm as JB
from boundless_tpu.core import field as JF
from boundless_tpu_torch.core import bbmm as B
from boundless_tpu_torch.kernels import bbmm as BK

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_emu_build  # noqa: E402


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


def same(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("m,k,w", [(1, 1, 1), (100, 37, 4), (64, 300, 8)])
def test_weighted_sum(m, k, w):
    v, wt = words((m, k), m), words((k, w), k)
    v[0, : min(k, 3)] = [JF.P - 1, 0, 1][: min(k, 3)]
    same(B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                           torch.from_numpy(wt.astype(np.int32))),
         JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                            jnp.asarray(wt.astype(np.uint32))))


def test_weighted_sum_small_chunks(monkeypatch):
    """Many K chunks accumulate exactly as one."""
    v, wt = words((33, 70), 1), words((70, 4), 2)
    want = B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                             torch.from_numpy(wt.astype(np.int32)))
    monkeypatch.setattr(B, "CHUNK_ELEMS", 33 * 4 * 3)
    got = B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                            torch.from_numpy(wt.astype(np.int32)))
    assert torch.equal(got, want)


def test_weighted_sum_transposed():
    vt, wt = words((45, 20), 3), words((45, 4), 4)
    same(B.bb_weighted_sum_t(torch.from_numpy(vt.astype(np.int32)),
                             torch.from_numpy(wt.astype(np.int32))),
         JB.bb_weighted_sum_t(jnp.asarray(vt.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32))))


# -- the dispatch -------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version():
    v, wt = words((50, 40), 5), words((40, 8), 6)
    launches, plain = BK.LAUNCHES, B.PLAIN_ON_CUDA
    got = B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                            torch.from_numpy(wt.astype(np.int32)))
    got_t = B.bb_weighted_sum_t(torch.from_numpy(v.T.astype(np.int32)),
                                torch.from_numpy(wt.astype(np.int32)))
    assert BK.LAUNCHES == launches and B.PLAIN_ON_CUDA == plain
    same(got, JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                                 jnp.asarray(wt.astype(np.uint32))))
    assert torch.equal(got, got_t)


def test_kernel_wrapper_refuses_cpu_tensors():
    v = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        BK.weighted_sum(v, torch.zeros((3, 4), dtype=torch.int32))


def test_layouts_the_kernel_reads_in_place():
    big = torch.zeros((64, 100), dtype=torch.int32)
    assert BK.row_stride(big) == 100
    assert BK.row_stride(big[:, 10:40]) == 100  # a column slice
    assert BK.row_stride(big[::4]) == 400  # a row step
    assert BK.row_stride(big[:, 5:6]) == 100  # K = 1
    assert BK.row_stride(big[0].reshape(100, 1).t()) == 1  # M = 1
    for view in (big[::2, ::2], big.t(), big[:1, ::2]):
        with pytest.raises(ValueError, match="not row-major"):
            BK.row_stride(view)  # bb_weighted_sum_t's view among them


# -- the CUDA source on emulated threads --------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = cuda_emu_build.build("bbmm.cu", tmp_path_factory.mktemp("emubbmm"))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bt_bbmm.argtypes = [vp, ll, vp, i, vp, ll, ctypes.c_uint, vp]
    lib.bt_bbmm.restype = i
    return lib


def run_emulated(lib, v, wt, pad=0):
    """csrc/bbmm.cu on host memory: v (M, K) as the columns past `pad` of
    an (M, K + pad) array (row stride K + pad)."""
    m, k = v.shape
    host = np.zeros((m, k + pad), np.uint32)
    host[:, pad:] = v
    w = np.ascontiguousarray(wt.astype(np.uint32))
    out = np.zeros((m, w.shape[1]), np.uint32)
    assert lib.bt_bbmm(host.ctypes.data + 4 * pad, k + pad, w.ctypes.data,
                       w.shape[1], out.ctypes.data, m, k, None) == 0
    return out


EMU_CASES = [
    (1, 1, 4, 0),      # K = 1, M = 1
    (1, 70, 8, 3),     # M = 1, K over three tiles, a column slice
    (130, 70, 4, 0),   # M not a multiple of the block
    (130, 100, 8, 5),  # the DEEP width, a row stride past K
    (257, 33, 8, 7),   # three blocks, the last of one row
    (300, 45, 4, 1),   # K not a multiple of the 4-product group
]


@pytest.mark.parametrize("m,k,w,pad", EMU_CASES)
def test_cuda_source_on_emulated_threads(emulated, m, k, w, pad):
    v, wt = words((m, k), 100 + m), words((k, w), 200 + k)
    got = run_emulated(emulated, v, wt, pad)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_cuda_source_refuses_other_widths(emulated):
    v, w, out = (np.zeros(n, np.uint32) for n in (8, 12, 12))
    for width in (1, 3, 5, 9):
        assert emulated.bt_bbmm(v.ctypes.data, 2, w.ctypes.data, width,
                                out.ctypes.data, 4, 2, None) == 1


@pytest.mark.parametrize("w,pad", [(4, 0), (8, 0), (4, 5)])
def test_cuda_source_worst_case_sum_on_emulated_threads(emulated, w, pad):
    """Every word P - 1 at K = 8,112 (KeccakAir's lanes): the largest
    products and the most folds the accumulator takes on the path."""
    m, k = 3, 8112
    v = np.full((m, k), JF.P - 1, np.int64)
    wt = np.full((k, w), JF.P - 1, np.int64)
    got = run_emulated(emulated, v, wt, pad)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    plain = B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                              torch.from_numpy(wt.astype(np.int32)))
    same(plain, want)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    for m, k, w, pad in EMU_CASES + [(3, 8112, 8, 0)]:
        host = torch.from_numpy(words((m, k + pad), m).astype(np.int32))
        host = host.to(dev)
        wt = torch.from_numpy(words((k, w), k).astype(np.int32)).to(dev)
        got = B.bb_weighted_sum(host[:, pad:], wt)  # row stride K + pad
        want = B.bb_weighted_sum_plain(host[:, pad:], wt)
        assert torch.equal(got, want), (m, k, w, pad)
