"""Port parity: the exact weighted sums against JAX's int8-limb MXU sums
(`core/bbmm.py`), bit for bit (tolerance 0).

The plain version (CPU tensors) against JAX, with many chunks and
transposed, and over column blocks; the dispatch (a CPU tensor runs the
plain version and launches nothing; the kernel's wrapper refuses CPU
tensors, reads row-major views in place and refuses transposed ones,
builds the column-block table and plans the split of K); `csrc/bbmm.cu`
built by g++ against `tests/cuda_emu.h` (emulated threads and exact
emulations of the int8 tensor-core product, ldmatrix and cp.async) on host
memory, against JAX `bb_weighted_sum`: K over several tiles, M = 1 and M
not a multiple of the block, W = 4 and 8 (any other width refused), row
strides past the matrix, K split over blocks and in one slice, every word
P - 1 and the largest byte sums at K = 8,112, and a block table of three
blocks, a broadcast column and an ext item against JAX
`_combine_pointwise`. The emulated tensor-core product is held to a numpy
u8 product through a probe that places the PTX ISA's fragments
(tests/mma_probe.py; tests/test_torch_kernels_cuda.py runs the same probe
on the card). A `cuda`-marked case holds the kernel to its plain version
on the card and skips here.
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
from boundless_tpu.core import ntt as JNTT
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu_torch.core import bbmm as B
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import bbmm as BK
from boundless_tpu_torch.air import dsl
from boundless_tpu_torch.prover import stark

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_emu_build  # noqa: E402
from mma_probe import MMA_PROBE, mma_case  # noqa: E402


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


H100_SMS = 132


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = cuda_emu_build.build("bbmm.cu", tmp_path_factory.mktemp("emubbmm"))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bt_bbmm.argtypes = [vp, vp, vp, i, vp, i, vp, ll, ctypes.c_uint,
                            vp, vp]
    lib.bt_bbmm.restype = i
    return lib


def host_words(a):
    """A uint32 numpy array as an int32 CPU tensor on the same memory."""
    return torch.from_numpy(a.view(np.int32))


def run_blocks(lib, blocks, wt, sms=H100_SMS, cols=None):
    """csrc/bbmm.cu on host memory: the column blocks (CPU tensors) through
    the wrapper's table (`block_table`), K in slices of `cols` words (by
    default the wrapper's plan for a card of `sms` SMs)."""
    m, table = BK.block_table(blocks)
    k = sum(w for _, _, w in table)
    w = np.ascontiguousarray(wt.astype(np.uint32))
    cols = cols or BK.plan(m, k, sms)[0]
    slices = max(1, -(-k // cols))
    out = np.zeros((m, w.shape[1]), np.uint32)
    partial = np.zeros((slices, m, w.shape[1]), np.uint32)
    n = len(table)
    ptrs = (ctypes.c_void_p * max(1, n))(*[p for p, _, _ in table])
    lds = (ctypes.c_longlong * max(1, n))(*[ld for _, ld, _ in table])
    widths = (ctypes.c_uint * max(1, n))(*[x for _, _, x in table])
    assert lib.bt_bbmm(ptrs, lds, widths, n, w.ctypes.data, w.shape[1],
                       out.ctypes.data, m, cols, partial.ctypes.data,
                       None) == 0
    return out


def run_emulated(lib, v, wt, pad=0, sms=H100_SMS, cols=None):
    """csrc/bbmm.cu on host memory: v (M, K) as the columns past `pad` of
    an (M, K + pad) array (row stride K + pad), one block."""
    m, k = v.shape
    host = np.zeros((m, k + pad), np.uint32)
    host[:, pad:] = v
    return run_blocks(lib, [host_words(host)[:, pad:]], wt, sms, cols)


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
    ptrs, lds = (ctypes.c_void_p * 1)(v.ctypes.data), (ctypes.c_longlong * 1)(2)
    widths = (ctypes.c_uint * 1)(2)
    for width in (1, 3, 5, 9):
        assert emulated.bt_bbmm(ptrs, lds, widths, 1, w.ctypes.data, width,
                                out.ctypes.data, 4, BK.KT, None, None) == 1
    for cols in (0, BK.KT + 1, BK.SLICE_MAX + BK.KT):  # no whole tiles
        assert emulated.bt_bbmm(ptrs, lds, widths, 1, w.ctypes.data, 4,
                                out.ctypes.data, 4, cols, None, None) == 1


@pytest.mark.parametrize("w,pad", [(4, 0), (8, 0), (4, 5)])
def test_cuda_source_worst_case_sum_on_emulated_threads(emulated, w, pad):
    """Every word P - 1 at K = 8,112 (KeccakAir's α-combine with its ext
    items): the largest products, in the longest slices a block takes
    (SLICE_MAX words, then the rest)."""
    m, k = 3, 8112
    v = np.full((m, k), JF.P - 1, np.int64)
    wt = np.full((k, w), JF.P - 1, np.int64)
    got = run_emulated(emulated, v, wt, pad, cols=BK.SLICE_MAX)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    plain = B.bb_weighted_sum(torch.from_numpy(v.astype(np.int32)),
                              torch.from_numpy(wt.astype(np.int32)))
    same(plain, want)


def test_emulated_mma_equals_numpy_u8_product(tmp_path):
    """The emulated m16n8k32 u8 product and ldmatrix, fed fragments by the
    PTX ISA's layouts, equal a numpy u8 product."""
    lib = cuda_emu_build.build("mma_probe.cu", tmp_path, text=MMA_PROBE)
    vp = ctypes.c_void_p
    lib.bt_mma_probe.argtypes = [vp] * 6
    for seed in range(3):
        a, b, c, want = mma_case(seed)
        bt = np.ascontiguousarray(b.T)  # by columns
        d, e = np.zeros((16, 8), np.int32), np.zeros((16, 8), np.int32)
        assert lib.bt_mma_probe(a.ctypes.data, bt.ctypes.data, c.ctypes.data,
                                d.ctypes.data, e.ctypes.data, None) == 0
        np.testing.assert_array_equal(d, want)
        np.testing.assert_array_equal(e, want)


@pytest.mark.parametrize("m,k,w,sms,slices", [
    (100, 480, 4, H100_SMS, 15),  # the verifier's rows: one tile a slice
    (192, 480, 8, 3, 4),          # three row tiles over four slices
    (70, 4200, 4, 1, 2),          # past SLICE_MAX: two slices
])
def test_cuda_source_split_k_on_emulated_threads(emulated, m, k, w, sms,
                                                 slices):
    """K split over blocks: partial sums to the workspace, then the second
    launch's sum mod P."""
    assert BK.plan(m, k, sms)[1] == slices
    v, wt = words((m, k), 300 + m), words((k, w), 400 + k)
    got = run_emulated(emulated, v, wt, 0, sms)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("m,k,w,pad", [(1000, 100, 8, 3), (640, 37, 4, 0),
                                       (65, 4096, 4, 1)])
def test_cuda_source_one_slice_on_emulated_threads(emulated, m, k, w, pad):
    """All of K in each block, up to SLICE_MAX words."""
    v, wt = words((m, k), 500 + m), words((k, w), 600 + k)
    got = run_emulated(emulated, v, wt, pad, cols=BK.SLICE_MAX)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_cuda_source_largest_byte_sums_on_emulated_threads(emulated):
    """Every word 0x77FFFFFF, the largest byte sums of a word below P (each
    adds 195,075 to C_2), at K = 8,112 in the longest slices (SLICE_MAX
    words, then the rest): the s32 accumulators' margin."""
    m, k, w = 3, 8112, 4
    v = np.full((m, k), 0x77FFFFFF, np.int64)
    wt = np.full((k, w), 0x77FFFFFF, np.int64)
    got = run_emulated(emulated, v, wt, 0, cols=BK.SLICE_MAX)
    want = JB.bb_weighted_sum(jnp.asarray(v.astype(np.uint32)),
                              jnp.asarray(wt.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def combine_case(m=70, seed=9):
    """Port and JAX α-combine items on the same words: three blocks (a
    VecVal of five columns read from inside a wider matrix, a base column
    of it, a VecVal of three), a constant column the port broadcasts, and
    an ExtVal item; the sizes and α."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, JF.P, size=(m, 12), dtype=np.int64)
    vec3 = rng.integers(0, JF.P, size=(m, 3), dtype=np.int64)
    ext = rng.integers(0, JF.P, size=(m, 4), dtype=np.int64)
    const = rng.integers(0, JF.P, size=(1,), dtype=np.int64)
    alpha = rng.integers(0, JF.P, size=(4,), dtype=np.int64)
    t = torch.from_numpy(big.astype(np.int32))
    port = [dsl.VecVal(t[:, 2:7]), t[:, 9], dsl.ExtVal(
        torch.from_numpy(ext.astype(np.int32))), dsl.VecVal(
        torch.from_numpy(vec3.astype(np.int32))),
        torch.from_numpy(const.astype(np.int32))]

    def j(x):
        return jnp.asarray(x.astype(np.uint32))

    jax = [JSTARK.VecVal(j(big[:, 2:7])), j(big[:, 9]), JSTARK.ExtVal(j(ext)),
           JSTARK.VecVal(j(vec3)), j(np.broadcast_to(const, (m,)))]
    return port, jax, [5, 1, 1, 3, 1], alpha


def test_block_table_equals_jax_combine_pointwise(emulated, monkeypatch):
    """The port's α-combine through the kernel's column-block table (three
    blocks, a broadcast column, an ext item's coordinates under α^k X^i)
    on emulated threads, and through the plain version, against JAX
    `_combine_pointwise` on the same words: tolerance 0."""
    port, jax, sizes, alpha = combine_case()
    want = np.asarray(JSTARK._combine_pointwise(
        jax, sizes, JNTT.ext_powers(jnp.asarray(alpha.astype(np.uint32)),
                                    sum(sizes))))
    apows = NTT.ext_powers(torch.from_numpy(alpha.astype(np.int32)),
                           sum(sizes))
    same(stark._combine_pointwise(port, sizes, apows), want)  # plain
    tables = []

    def on_emulated_threads(blocks, weights):
        tables.append(BK.block_table(blocks)[1])
        return host_words(run_blocks(emulated, blocks,
                                     weights.numpy().view(np.uint32)))

    monkeypatch.setattr(stark.bbmm, "bb_weighted_sum_blocks",
                        on_emulated_threads)
    same(stark._combine_pointwise(port, sizes, apows), want)
    (table,) = tables
    assert [(ld, w) for _, ld, w in table] == [(12, 5), (12, 1), (3, 3),
                                                (0, 1), (4, 4)]


def test_weighted_sum_blocks_plain_equals_jax():
    """bb_weighted_sum_blocks on CPU tensors (the plain version) equals JAX
    bb_weighted_sum of the blocks joined, a one-row block broadcast."""
    m = 33
    big = words((m, 10), 11)
    row = words((1, 2), 12)
    wt = words((8 + 2 + 1, 8), 13)
    t = torch.from_numpy(big.astype(np.int32))
    got = B.bb_weighted_sum_blocks(
        [t[:, 1:9], torch.from_numpy(row.astype(np.int32)), t[:, 9:]],
        torch.from_numpy(wt.astype(np.int32)))
    joined = np.concatenate([big[:, 1:9], np.broadcast_to(row, (m, 2)),
                             big[:, 9:]], 1)
    same(got, JB.bb_weighted_sum(jnp.asarray(joined.astype(np.uint32)),
                                 jnp.asarray(wt.astype(np.uint32))))


def test_block_table_and_plan():
    big = torch.zeros((64, 100), dtype=torch.int32)
    m, table = BK.block_table([big[:, :40], big[:1, 40:45], big[:, 45:45],
                               big[:1, 50:53].expand(64, 3)])
    assert m == 64
    assert [(ld, w) for _, ld, w in table] == [(100, 40), (0, 5), (0, 3)]
    assert table[1][0] == big[:1, 40:45].data_ptr()
    with pytest.raises(ValueError, match="rows"):
        BK.block_table([big, big[:3]])
    with pytest.raises(ValueError, match="blocks"):
        BK.block_table([big[:1, :1]] * (BK.MAX_BLOCKS + 1))
    with pytest.raises(ValueError, match="not row-major"):
        BK.block_table([big.t()])
    # (slice_cols, slices) of the path's calls on the H100's 132 SMs
    assert BK.plan(1 << 18, 480, H100_SMS) == (480, 1)  # main DEEP
    assert BK.plan(1 << 18, 16, H100_SMS) == (32, 1)  # its check columns
    assert BK.plan(1 << 22, 77, H100_SMS) == (96, 1)  # lift α 4N
    assert BK.plan(100, 480, H100_SMS) == (32, 15)  # verifier rows
    assert BK.plan(1 << 12, 8112, H100_SMS) == (928, 9)  # KeccakAir α
    assert BK.plan(1 << 11, 4104, H100_SMS) == (256, 17)  # KeccakAir DEEP
    for m, k in ((1, 1), (3, 8112), (1 << 12, 8112), (5000, 70000)):
        cols, slices = BK.plan(m, k, H100_SMS)
        assert cols % BK.KT == 0 and cols <= BK.SLICE_MAX
        assert (slices - 1) * cols < k <= slices * cols
    assert BK.launches_of(1 << 18, 480, H100_SMS) == 1
    assert BK.launches_of(100, 480, H100_SMS) == 2


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

