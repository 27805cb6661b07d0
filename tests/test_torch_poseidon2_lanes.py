"""The Poseidon2 sponge's lane-split schedule and tree top, on the CPU.

A numpy model of how `csrc/poseidon2.cu` moves the data (below): which state words each lane of a group holds, the butterfly
partners of the cross-lane sums, the internal rounds' order (word 0's
S-box, then the sums), the rate chunks each lane loads, the zero padding,
the idle lanes and the tree top's buffers and passes. Field sums are exact
in any order, so the data movement is what these tests check:
  * the model, for each lanes-a-hash layout, equals the JAX reference
    (`boundless_tpu.core.poseidon2`) and the port's plain sponge;
  * the plain tree top equals the level loop and JAX's `merkle.commit`;
  * the CUDA source itself, built with g++ against a CPU emulation of
    warps (`tests/cuda_emu.h`: one OS thread a CUDA thread, shuffles and
    __syncthreads at barriers), equals the plain sponge in every layout
    and the plain tree top.
Exact equality throughout (field words). The card's own tests are in
`test_torch_poseidon2_cuda.py`.
"""

import ctypes
import functools
import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import merkle as JM
from boundless_tpu.core import poseidon2 as JP2
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import merkle as M
from boundless_tpu_torch.core import poseidon2 as P2
from boundless_tpu_torch.kernels import poseidon2 as P2K

GROUPS = P2K.LANES
# ("init", 0): one permutation of an initial state; else C input columns:
# part-filled blocks (1, 15), a whole one (16), one word into a second
# block (17, 33) and the main path's data rows (392)
COLS = ["init", 1, 15, 16, 17, 33, 392]
ROWS = (1, 5)
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "boundless_tpu_torch", "csrc")


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int64).astype(np.uint32))


def canon(x) -> np.ndarray:
    """Montgomery words (torch or jax) -> canonical int64 numpy."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return F.from_mont(t(x.astype(np.int64))).numpy().astype(np.int64)


@functools.lru_cache(maxsize=None)
def case(n: int, cols):
    """(Montgomery input or init state, JAX result) for N rows."""
    if cols == "init":
        st = words((n, P2.WIDTH), 3 + n)
        return st, np.asarray(JP2.permute(j(st))).astype(np.int64)
    x = words((n, cols), 100 * n + cols)
    return x, np.asarray(JP2.hash_elems(j(x))).astype(np.int64)


# -- numpy model of the lane-split schedule of csrc/poseidon2.cu -----------
#
# Canonical int64 words. Each array has one row per thread of a launch;
# the model moves the data as the kernel does (which lane holds which
# words, the butterfly partners of each cross-lane sum, the S-box of word
# 0 before the internal sum, the rate chunks each lane loads, the zero
# padding, the idle and past-the-end lanes, the tree top's buffers and
# passes). Field sums are exact in any order, so the data movement is what
# it checks.

WARP = 32


def cu_constant(name: str) -> int:
    """A `constexpr int` of csrc/poseidon2.cu."""
    with open(os.path.join(CSRC, "poseidon2.cu")) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1))


TREE_THREADS = cu_constant("TREE_THREADS")  # the tree-top kernel's block
TREE_MAX = cu_constant("TREE_MAX")  # nodes of the largest level it takes
_M4 = np.array([[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]],
               dtype=np.int64)


def lane_layout(group: int):
    """Lanes a hash -> (whole M4 chunks a lane K, active lanes 6 / K)."""
    k = {1: 6, 2: 3, 4: 2, 8: 1}[group]
    return k, P2.WIDTH // 4 // k


def lane_words(group: int, lane: int) -> list:
    """The state words lane `lane` of a group holds (none if idle)."""
    k, active = lane_layout(group)
    return list(range(4 * k * lane, 4 * k * (lane + 1))) if lane < active \
        else []


def shuffle_offsets(group: int) -> list:
    """XOR offsets of the butterfly steps of a cross-lane sum: lane l
    exchanges with l ^ 1, l ^ 2, ..., inside its group of `group` lanes."""
    return [1 << s for s in range(group.bit_length() - 1)]


def rate_loads(group: int, lane: int, c0: int, cols: int, vec4: bool):
    """The loads lane `lane` makes for the rate block at column c0:
    [(state word, first column, words, "vec4" or "scalar")]. Chunk q < 4
    (state words 4q .. 4q + 3) takes columns c0 + 4q ..; columns past
    `cols` are the zero padding, not loaded."""
    k, active = lane_layout(group)
    loads = []
    for q in range(k * lane, k * lane + k) if lane < active else ():
        w0 = c0 + 4 * q
        if q >= P2.RATE // 4 or w0 >= cols:
            continue
        if vec4 and w0 + 4 <= cols:
            loads.append((4 * q, w0, 4, "vec4"))
        else:
            loads.extend((4 * q + c, w0 + c, 1, "scalar")
                         for c in range(min(4, cols - w0)))
    return loads


def _lanes(threads: int, group: int):
    t = np.arange(threads)
    g = t % group
    k, active = lane_layout(group)
    act = g < active
    base = np.where(act, g * 4 * k, 0)
    return g, act, base[:, None] + np.arange(4 * k)


def _group_sum(v, group: int, act):
    """Butterfly sum inside each group (v: one value a thread)."""
    v = np.where(act, v, 0)
    t = np.arange(len(v))
    for o in shuffle_offsets(group):
        v = (v + v[t ^ o]) % F.P
    return v


def _lanes_external_linear(s, group: int, act):
    k = s.shape[1] // 4
    y = np.einsum("ij,tkj->tki", _M4, s.reshape(-1, k, 4)) % F.P
    tot = np.stack([_group_sum(y[:, :, c].sum(axis=1) % F.P, group, act)
                    for c in range(4)], axis=1)
    return ((y + tot[:, None, :]) % F.P).reshape(s.shape)


def _sbox7(x):
    x3 = x * x % F.P * x % F.P
    return x3 * x3 % F.P * x % F.P


def _internal_rounds_split(s, group: int, g, act, words):
    """The internal rounds of a lane group (csrc/poseidon2.cu
    `internal_rounds_split`): every lane runs word 0's chain v0 -> x0 =
    sbox(v0 + rc) -> S_r = x0 + L_r -> v0 = mu_0 x0 + S_r, where L_r (the
    sum of words j > 0) is M_{r-1} + 23 S_{r-1}: the group sum of round
    r - 1's products m_j = mu_j v_j (j > 0), taken in round r - 1 before
    its S-box. Each lane's words become m_j + S_r; the lane that holds
    word 0 takes v0 at the end."""
    _, int_rc, mu = P2.canonical_constants()
    lead0 = (g == 0)[:, None] & (np.arange(s.shape[1]) == 0)  # word 0
    v0 = s[np.arange(len(s)) - g, 0]  # from the group's first lane
    l = _group_sum(np.where(lead0, 0, s).sum(axis=1) % F.P, group, act)
    for r in range(P2.ROUNDS_PARTIAL):
        m = mu[words] * s % F.P
        m_sum = _group_sum(np.where(lead0, 0, m).sum(axis=1) % F.P, group,
                           act)
        x0 = _sbox7((v0 + int_rc[r]) % F.P)
        total = (x0 + l) % F.P  # S_r
        v0 = (mu[0] * x0 + total) % F.P
        s = (m + total[:, None]) % F.P
        l = (m_sum + (P2.WIDTH - 1) * total) % F.P  # L_{r+1}
    s[g == 0, 0] = v0[g == 0]
    return s


def lanes_permute(s, group: int):
    """One permutation of the lane states s (threads, 4K): thread t is
    lane t % group of its hash; threads are whole warps."""
    ext_rc, int_rc, mu = P2.canonical_constants()
    g, act, words = _lanes(len(s), group)
    s = _lanes_external_linear(s, group, act)
    half = P2.ROUNDS_FULL // 2
    for r in range(half):
        s = _lanes_external_linear(_sbox7((s + ext_rc[r][words]) % F.P),
                                   group, act)
    if group == 1:
        for r in range(P2.ROUNDS_PARTIAL):
            s = s.copy()
            s[:, 0] = _sbox7((s[:, 0] + int_rc[r]) % F.P)
            s = (s * mu[words] + s.sum(axis=1, keepdims=True)) % F.P
    else:
        s = _internal_rounds_split(s, group, g, act, words)
    for r in range(half, P2.ROUNDS_FULL):
        s = _lanes_external_linear(_sbox7((s + ext_rc[r][words]) % F.P),
                                   group, act)
    return s


def lanes_hash_rows(matrix, group: int, init=None,
                    out_words: int = P2.DIGEST_WORDS, vec4: bool = True):
    """Model of the sponge kernel with `group` lanes a hash over an (N, C)
    canonical int64 matrix -> (N, out_words); `init` (N, 24) or None."""
    n, cols = matrix.shape
    threads = -(-n * group // WARP) * WARP
    g, act, words = _lanes(threads, group)
    i = np.arange(threads) // group
    own = (i < n) & act
    hi = np.minimum(i, n - 1)
    s = np.zeros(words.shape, dtype=np.int64)
    if init is not None:
        s = np.where(own[:, None], np.asarray(init)[hi[:, None], words], 0)
    loads = {(lane, c0): rate_loads(group, lane, c0, cols, vec4)
             for lane in range(group)
             for c0 in range(0, max(cols, 1), P2.RATE)}
    for c0 in range(0, max(cols, 1), P2.RATE):
        for lane in range(group):
            rows = np.nonzero(own & (g == lane))[0]
            for word, col, width, _ in loads[(lane, c0)]:
                j = word - 4 * lane_layout(group)[0] * lane
                s[rows, j:j + width] = (s[rows, j:j + width]
                                        + matrix[i[rows], col:col + width]) \
                    % F.P
        s = lanes_permute(s, group)
    out = np.full((n, out_words), -1, dtype=np.int64)
    keep = own[:, None] & (words < out_words)
    tt, jj = np.nonzero(keep)
    assert np.all(out[i[tt], words[tt, jj]] == -1), "a word stored twice"
    out[i[tt], words[tt, jj]] = s[tt, jj]
    assert np.all(out >= 0), "a digest word never stored"
    return out


def tree_lanes(h: int, threads: int = TREE_THREADS) -> int:
    """Lanes a hash for a tree-top level of h hashes: the most that fit
    the block in one pass, else one."""
    for group in GROUPS[::-1]:
        if h * group <= threads or group == 1:
            return group


def lanes_tree_top(level, threads: int = TREE_THREADS):
    """Model of the tree-top kernel over an (M, 8) canonical level -> the
    (M - 1, 8) output (levels M/2, ..., 1 one after another): the shared
    buffers of M and M/2 nodes in turn, TREE_THREADS / G hashes a pass, a
    warp stopping once its first hash is past the level."""
    m = level.shape[0]
    assert 2 <= m <= TREE_MAX and m & (m - 1) == 0
    a = np.asarray(level, dtype=np.int64).reshape(-1).copy()
    b = np.zeros(m // 2 * P2.DIGEST_WORDS, dtype=np.int64)
    out = np.full((m - 1) * P2.DIGEST_WORDS, -1, dtype=np.int64)
    off, h = 0, m // 2
    while h >= 1:
        group = tree_lanes(h, threads)
        k, _ = lane_layout(group)
        g, act, words = _lanes(threads, group)
        slot = np.arange(threads) // group
        warp_slot = (np.arange(threads) & ~(WARP - 1)) // group
        for first in range(0, h, threads // group):
            run = first + warp_slot < h  # whole warps
            i = first + slot
            own = (i < h) & act & run
            s = np.zeros(words.shape, dtype=np.int64)
            q = g[:, None] * k + np.arange(k)[None, :]  # (threads, K) chunks
            for kk in range(k):
                for c in range(4):
                    src = 16 * i + 4 * q[:, kk] + c
                    take = own & (q[:, kk] < P2.RATE // 4)
                    s[take, 4 * kk + c] = a[src[take]]
            s[run] = lanes_permute(s[run], group)
            tt, jj = np.nonzero(own[:, None] & (words < P2.DIGEST_WORDS))
            dst = P2.DIGEST_WORDS * i[tt] + words[tt, jj]
            b[dst] = s[tt, jj]
            out[off + dst] = s[tt, jj]
        off += h * P2.DIGEST_WORDS
        a, b = b, a
        h //= 2
    assert np.all(out >= 0), "a node never stored"
    return out.reshape(m - 1, P2.DIGEST_WORDS)


# -- the model against the reference -------------------------------------


@pytest.mark.parametrize("group", GROUPS)
def test_lane_words_partition_the_state_in_whole_chunks(group):
    k, active = lane_layout(group)
    assert k * active == P2.WIDTH // 4 and active <= group
    held = [lane_words(group, lane) for lane in range(group)]
    assert sorted(w for ws in held for w in ws) == list(range(P2.WIDTH))
    for lane, ws in enumerate(held):
        if lane >= active:
            assert ws == []
        else:
            assert len(ws) == 4 * k and ws[0] % 4 == 0
            assert ws == list(range(ws[0], ws[0] + 4 * k))


@pytest.mark.parametrize("group", GROUPS)
def test_shuffle_partners_span_the_group_and_stay_in_it(group):
    offsets = shuffle_offsets(group)
    assert len(offsets) == group.bit_length() - 1
    for lane in range(WARP):
        reach = {lane}
        for o in offsets:  # the butterfly: each step doubles what is summed
            assert (lane ^ o) // group == lane // group
            reach |= {r ^ o for r in reach}
        assert reach == set(range(lane - lane % group,
                                  lane - lane % group + group))


@pytest.mark.parametrize("vec4", [True, False])
@pytest.mark.parametrize("group", GROUPS)
def test_rate_blocks_split_across_lanes(group, vec4):
    k, active = lane_layout(group)
    for cols in (1, 15, 16, 17, 33, 392, 4048):
        for c0 in range(0, cols, P2.RATE):
            got = []
            for lane in range(group):
                for word, col, width, kind in rate_loads(group, lane, c0,
                                                            cols, vec4):
                    assert word in lane_words(group, lane) and word < 16
                    assert word - 4 * k * lane + width <= 4 * k
                    assert (kind == "vec4") == (width == 4)
                    if kind == "vec4":
                        assert vec4 and col % 4 == 0 and col + 4 <= cols
                    got.extend(range(col, col + width))
                    assert col - c0 == word  # rate word w takes column c0 + w
            # every column of the block once; the padding loads nothing
            assert sorted(got) == list(range(c0, min(c0 + P2.RATE, cols)))


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("group", GROUPS)
def test_lane_model_equals_reference(group, cols):
    for n in ROWS:
        x, want = case(n, cols)
        if cols == "init":
            got = lanes_hash_rows(np.zeros((n, 0), dtype=np.int64), group,
                                     init=canon(x), out_words=P2.WIDTH)
            plain = P2.permute(t(x))
        else:
            got = lanes_hash_rows(canon(x), group, vec4=n % 2 == 1)
            plain = P2.hash_rows(t(x))
        np.testing.assert_array_equal(got, canon(want))
        np.testing.assert_array_equal(canon(plain), canon(want))


@pytest.mark.parametrize("m", [2, 4, 64, 512, 4096])
def test_tree_top_model_equals_plain(m):
    level = words((m, 8), m)
    want = torch.cat(P2.hash_tree(t(level)))
    np.testing.assert_array_equal(lanes_tree_top(canon(level)),
                                  canon(want))


def test_tree_lanes_fill_the_block_in_one_pass():
    for k in range(12):
        h = 1 << k
        fit = [g for g in GROUPS if h * g <= TREE_THREADS]
        assert tree_lanes(h) == max(fit, default=1)


@pytest.mark.parametrize("n", [2, 16, 256])
def test_plain_tree_top_equals_level_loop_and_jax(n):
    x = words((n, 9), n)
    jtree = JM.commit(j(x))
    leaves = P2.hash_rows(t(x))
    levels = [leaves] + P2.hash_tree(leaves)
    loop = [leaves]
    while loop[-1].shape[0] > 1:
        loop.append(P2.hash_pair(loop[-1][0::2], loop[-1][1::2]))
    assert len(levels) == len(loop) == len(jtree.levels)
    for lvl, lp, jl in zip(levels, loop, jtree.levels):
        assert torch.equal(lvl, lp)
        np.testing.assert_array_equal(lvl.numpy().astype(np.int64),
                                      np.asarray(jl).astype(np.int64))
    assert P2K.hash_tree(leaves)[-1].shape == (1, 8)  # CPU: the plain loop


@pytest.mark.parametrize("top", [1, 4, 1024])
def test_commit_levels_under_any_tree_top(monkeypatch, top):
    x = t(words((64, 5), 64))
    want = M.commit(x).levels
    monkeypatch.setattr(P2K, "TREE_TOP", top)
    got = M.commit(x).levels
    assert len(got) == len(want) == 7
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_lanes_for_follows_the_crossovers():
    picks = [P2K.lanes_for(1 << k) for k in range(23)]
    assert picks == sorted(picks, reverse=True)
    assert picks[0] == GROUPS[-1] and picks[-1] == 1
    for fewest, lanes in P2K.LANE_CROSSOVER:
        assert P2K.lanes_for(fewest) == lanes
        assert P2K.lanes_for(fewest - 1) != lanes
    assert P2K.TREE_TOP <= TREE_MAX


# -- the CUDA source on emulated warps ------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/poseidon2.cu built with g++ against tests/cuda_emu.h."""
    with open(os.path.join(CSRC, "poseidon2.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("extern __shared__ uint32_t smem[];",
                      "uint32_t* smem = ::smem;")
    src, launches = re.subn(
        r"([\w<>]+)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(",
        r"emu_launch(\2, \3, \4, \1, ", src)
    assert launches == 2
    out = tmp_path_factory.mktemp("emu")
    cpp, so = out / "poseidon2_emu.cpp", out / "libp2emu.so"
    cpp.write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-w", "-I", HERE, "-I", CSRC, "-o", str(so),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bt_p2_set_constants.argtypes = [vp, vp, vp]
    lib.bt_p2_sponge.argtypes = [vp, ctypes.c_longlong, i, i, vp, vp, i, i,
                                 vp]
    lib.bt_p2_tree.argtypes = [vp, i, vp, vp]
    tables = [np.ascontiguousarray(c, dtype=np.uint32)
              for c in P2.constants()]
    assert lib.bt_p2_set_constants(*(c.ctypes.data for c in tables)) == 0
    return lib


@pytest.mark.parametrize("group", GROUPS)
def test_cuda_source_sponge_on_emulated_warps(emulated, group):
    for n, cols in ((1, 0), (3, 7), (31, 16), (5, 17), (2, 392), (20, 15)):
        x = words((n, cols), 7 * n + cols)
        init = words((n, P2.WIDTH), n) if cols == 0 else None
        out_words = P2.WIDTH if cols == 0 else P2.DIGEST_WORDS
        want = P2.hash_rows(t(x), init=None if init is None else t(init),
                            out_words=out_words)
        xa = np.ascontiguousarray(x.astype(np.uint32))
        ia = None if init is None else np.ascontiguousarray(
            init.astype(np.uint32))
        for vec4 in (0, 1) if cols % 4 == 0 else (0,):
            out = np.zeros((n, out_words), dtype=np.uint32)
            assert emulated.bt_p2_sponge(
                xa.ctypes.data if cols else None, n, cols, vec4,
                None if ia is None else ia.ctypes.data, out.ctypes.data,
                out_words, group, None) == 0
            np.testing.assert_array_equal(out.astype(np.int64),
                                          want.numpy().astype(np.uint32))


@pytest.mark.parametrize("m", [2, 8, 128, 1024])
def test_cuda_source_tree_top_on_emulated_block(emulated, m):
    level = words((m, 8), m + 1)
    out = np.zeros((m - 1, 8), dtype=np.uint32)
    la = np.ascontiguousarray(level.astype(np.uint32))
    assert emulated.bt_p2_tree(la.ctypes.data, m, out.ctypes.data, None) == 0
    want = torch.cat(P2.hash_tree(t(level)))
    np.testing.assert_array_equal(out, want.numpy().astype(np.uint32))
