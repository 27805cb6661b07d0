"""The port's p254 hash suite against the JAX package.

Poseidon over BN254 Fr (`core/poseidon_bn254.py`), the `poseidon254`
suite's Merkle trees and `Transcript254` (`core/suites.py`), the sponge
kernel's CPU route (`kernels/poseidon254.py`), the kernel's sparse-matrix
schedule in Python ints (`permute_schedule`, `schedule_table`) and the CUDA
source itself (`csrc/poseidon254.cu`, built by g++ against
`tests/cuda_emu.h`, in every layout: one thread, 3 lanes, the tree top and
the path walk), and the p254-suite toy proof of `tests/test_suite254.py` (ProdAir, n = 32, 4
queries) proved by both packages. Tolerance 0 everywhere: exact field
arithmetic. A `cuda`-marked case holds the kernel to its plain version on
the card and skips here.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import poseidon_bn254 as JP254
from boundless_tpu.core import suites as JSUITES
from boundless_tpu.prover import stark as JSTARK
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import dsl
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import poseidon_bn254 as P254
from boundless_tpu_torch.core import suites
from boundless_tpu_torch.kernels import poseidon254 as P254K
from boundless_tpu_torch.prover import stark

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_emu_build  # noqa: E402
from test_suite254 import _toy_air as _jax_toy_air  # noqa: E402

TOY_PO2 = 5
TOY_PS = stark.ProofSystem(queries=4, fri_min_degree=8, commit_expand=2,
                           hash="poseidon254")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def canon(shape, seed):
    return np.random.default_rng(seed).integers(0, F.P, size=shape,
                                                dtype=np.int64)


def felts(count, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P254.FR
            for _ in range(count)]


class ProdAir(dsl.Air):
    """The port's copy of the toy AIR of tests/test_suite254.py: next =
    prev * prev, first row pinned to pub[0]."""

    name = "prod254"
    ctrl_cols = 1
    data_cols = 1
    accum_cols = 0
    globals_count = 0
    max_degree = 3

    def ctrl_trace(self, n, device="cpu"):
        ct = np.zeros((n, 1), dtype=np.int64)
        ct[0, 0] = 1
        return F.fp(ct, device)

    def constraints(self, alg, now, nxt, globals_, pub):
        x = now.data[0]
        xn = nxt.data[0]
        nf = nxt.ctrl[0]
        c = [alg.mul(alg.sub(alg.one(), nf), alg.sub(xn, alg.mul(x, x)))]
        c.append(alg.mul(now.ctrl[0], alg.sub(x, alg.pubval(pub[0]))))
        return c


def toy_inputs(pub_vals):
    vals = [pub_vals[0]]
    for _ in range((1 << TOY_PO2) - 1):
        vals.append(vals[-1] * vals[-1] % F.P)
    return np.asarray(vals, dtype=np.int64)[:, None], np.asarray(
        pub_vals, dtype=np.int64)


def prove_toy(pub_vals, device="cpu"):
    """The port's p254 toy proof and its control root."""
    data, pub = toy_inputs(pub_vals)
    air = ProdAir()
    proof = stark.prove(air, F.fp(data, device), F.fp(pub, device), TOY_PO2,
                        TOY_PS, None)
    root = stark.control_root_of(air, TOY_PO2, ps=TOY_PS, device=device)
    return air, proof, root


# -- Poseidon over BN254 Fr ------------------------------------------------


def test_constants_equal_jax():
    assert P254.constants() == JP254.constants()


@pytest.mark.parametrize("seed", range(4))
def test_permutation_equals_jax(seed):
    s = felts(3, seed)
    assert P254.permute(s) == JP254.permute(s)


@pytest.mark.parametrize("seed", range(6))
def test_sparse_schedule_equals_jax_permutation(seed):
    """The kernel's schedule (constants moved to one scalar a partial
    round, sparse partial-round matrices, the lazy MDS's one reduction a
    row) in Python ints equals the reference permutation."""
    s = felts(3, 300 + seed)
    if seed == 0:
        s = [0, 0, 0]
    elif seed == 1:
        s = [P254.FR - 1] * 3
    assert P254K.permute_schedule(s) == JP254.permute(s)


def test_sparse_schedule_shape():
    sc = P254K.schedule()
    assert len(sc["full_rc"]) == 8 and len(sc["k"]) == 57
    assert sc["k"][-1] == 0  # nothing moves into the last partial round
    for m in sc["sparse"]:
        assert m[1][1:] == [1, 0] and m[2][1:] == [0, 1]


@pytest.mark.parametrize("count", [0, 1, 7, 8, 9, 16, 17, 48])
def test_pack_and_hash_bb_equal_jax(count):
    elems = [int(x) for x in canon(count, count)]
    assert P254.felts_of_bb(elems) == JP254.felts_of_bb(elems)
    if count <= P254.PACK:
        assert P254.pack_bb(elems) == JP254.pack_bb(elems)
    assert P254.hash_bb(elems) == JP254.hash_bb(elems)


@pytest.mark.parametrize("seed", range(3))
def test_squeeze_and_digest_words_equal_jax(seed):
    for f in felts(4, 10 + seed):
        assert P254.squeeze_bb(f) == JP254.squeeze_bb(f)
        assert P254.digest_words(f) == JP254.digest_words(f)
        assert P254.felt_of_words(P254.digest_words(f)) == f


@pytest.mark.parametrize("cols", [0, 1, 16, 24, 48, 64])
def test_hash_rows_np_equals_jax(cols):
    m = canon((4, cols), cols).astype(np.uint32)
    np.testing.assert_array_equal(P254.hash_rows_np(m), JP254.hash_rows_np(m))


def test_hash_pairs_np_equals_jax():
    digests = P254.hash_rows_np(canon((6, 9), 3).astype(np.uint32))
    np.testing.assert_array_equal(
        P254.hash_pairs_np(digests[:3], digests[3:]),
        JP254.hash_pairs_np(digests[:3], digests[3:]))


# -- the sponge wrapper's CPU route and the suite ----------------------------


@pytest.mark.parametrize("cols", [1, 16, 48, 64])
def test_cpu_route_hashes_montgomery_rows(cols):
    """hash_rows takes the prover's Montgomery words, as JAX's suite
    takes them out of Montgomery form before the host hash."""
    c = canon((5, cols), 40 + cols)
    got = P254K.words_np(P254K.hash_rows(F.fp(c)))
    np.testing.assert_array_equal(got, JP254.hash_rows_np(c.astype(np.uint32)))


def test_digest_words_keep_their_bit_patterns():
    words = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 5, 6, 7],
                     dtype=np.uint32)
    t = P254K.words_tensor(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(P254K.words_np(t), words)


def test_constant_tables_are_montgomery_felts():
    """The kernel's table holds the schedule's constants in Montgomery
    form (R = 2^256), in csrc/poseidon254.cu's TAB_* order."""
    sc = P254K.schedule()
    flat = ([v for row in sc["full_rc"] for v in row] + list(sc["post"])
            + list(sc["k"]) + [v for row in sc["mds"] for v in row]
            + [v for row in sc["pre"] for v in row]
            + [v for m in sc["sparse"] for row in m for v in row])
    table = P254K.schedule_table().reshape(-1, 8)
    assert table.shape[0] == len(flat) == 615
    r_inv = pow(1 << 256, -1, P254.FR)
    for v, w in zip(flat, table):
        x = sum(int(w[k]) << (32 * k) for k in range(8))
        assert x < P254.FR and x * r_inv % P254.FR == v


@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_commit_levels_equal_jax(n):
    m = canon((n, 5), n)
    tree = suites.get("poseidon254").commit(F.fp(m))
    jtree = JSUITES.get("poseidon254").commit(JF.fp(m))
    assert len(tree.levels) == len(jtree.levels)
    for lv, jl in zip(tree.levels, jtree.levels):
        np.testing.assert_array_equal(P254K.words_np(lv),
                                      np.asarray(jl, dtype=np.uint32))


def test_verify_rows_accepts_openings_and_refuses_a_flip():
    from boundless_tpu_torch.core import merkle

    m = F.fp(canon((16, 3), 9))
    suite = suites.get("poseidon254")
    tree = suite.commit(m)
    idx = torch.tensor([0, 5, 15], dtype=torch.int64)
    rows, paths = merkle.open_rows(tree, idx)
    assert bool(torch.all(suite.verify_rows(tree.root, idx, rows, paths)))
    bad = paths.clone()
    bad[1, 2, 3] ^= 1
    ok = suite.verify_rows(tree.root, idx, rows, bad)
    assert ok.tolist() == [True, False, True]


def _felt_words(x: int) -> list:
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_verify_rows_refuses_a_sibling_of_x_plus_r(device):
    """A path sibling x + r (the same felt mod r, not canonical) is
    refused on both routes, as JAX's host hash refuses it."""
    from boundless_tpu_torch.core import merkle

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    m = F.fp(canon((16, 3), 9)).to(device)
    suite = suites.get("poseidon254")
    tree = suite.commit(m)
    idx = torch.tensor([0, 5, 15], dtype=torch.int64, device=device)
    rows, paths = merkle.open_rows(tree, idx)
    words = P254K.words_np(paths[1, 2])
    x = sum(int(w) << (32 * k) for k, w in enumerate(words))
    bad = paths.clone()
    bad[1, 2] = P254K.words_tensor(_felt_words(x + P254.FR), device)
    with pytest.raises(ValueError, match="out of field range"):
        suite.verify_rows(tree.root, idx, rows, bad)
    with pytest.raises(AssertionError):
        JP254.felt_of_words(_felt_words(x + P254.FR))


@pytest.mark.parametrize("offset,ok", [(-1, True), (0, False), (1, False)])
def test_hash_level_takes_only_felts_below_r(offset, ok):
    left = P254K.words_tensor(_felt_words(P254.FR + offset), "cpu")
    pairs = torch.cat([left, torch.zeros(8, dtype=torch.int32)])[None]
    if ok:
        want = P254.hash_pair(P254.FR + offset, 0)
        assert P254K.words_np(P254K.hash_level(pairs))[0].tolist() == \
            _felt_words(want)
    else:
        with pytest.raises(ValueError, match="out of field range"):
            P254K.hash_level(pairs)


def test_transcript254_draws_the_jax_challenges():
    tr = suites.Transcript254("cpu")
    jtr = JSUITES.Transcript254()
    pub = canon(24, 1)
    tr.mix_pub(F.fp(pub))
    jtr.mix_pub(JF.fp(pub))
    digest = P254.hash_rows_np(canon((1, 8), 2).astype(np.uint32))[0]
    tr.mix_digest(P254K.words_tensor(digest, "cpu"))
    jtr.mix_digest(jnp.asarray(digest))
    got, want = [], []
    for step in range(3):
        got.append(F.from_mont(tr.sample_ext()).tolist())
        want.append(np.asarray(JF.from_mont(jtr.sample_ext())).tolist())
        elems = canon(11, 20 + step)
        tr.mix_elems(F.fp(elems))
        jtr.mix_elems(JF.fp(elems))
    got.append(tr.sample_indices(6, 9).tolist())
    want.append(np.asarray(jtr.sample_indices(6, 9)).tolist())
    got.append(F.from_mont(tr.sample_elem()).item())
    want.append(int(JF.from_mont(jtr.sample_elem())))
    got.append(tr.sample_u32().item())
    want.append(int(jtr.sample_u32()))
    assert got == want


# -- the toy proof, proved by both packages ---------------------------------


@pytest.fixture(scope="module")
def toy_proofs():
    """(port proof, port root, JAX proof, JAX root) of the toy with the
    one public of tests/test_suite254.py, both under BT_ZK_SEED."""
    torch.set_num_threads(1)
    old = os.environ.get("BT_ZK_SEED")
    os.environ["BT_ZK_SEED"] = "7"
    try:
        air, proof, root = prove_toy([3])
        data, pub = toy_inputs([3])
        jair = _jax_toy_air()
        jps = JSTARK.ProofSystem(queries=4, fri_min_degree=8,
                                 commit_expand=2, hash="poseidon254")
        jproof = JSTARK.prove(jair, JF.fp(data), JF.fp(pub), TOY_PO2, jps,
                              None)
        jroot = JSTARK.control_root_of(jair, TOY_PO2, ps=jps)
    finally:
        if old is None:
            os.environ.pop("BT_ZK_SEED")
        else:
            os.environ["BT_ZK_SEED"] = old
    return proof, root, jproof, jroot


def test_toy_proof_is_word_equal_to_jax(toy_proofs):
    proof, root, jproof, jroot = toy_proofs
    flat, jflat = convert.proof_to_numpy(proof), convert.proof_to_numpy(jproof)
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    np.testing.assert_array_equal(P254K.words_np(root),
                                  np.asarray(jroot, dtype=np.uint32))


def test_toy_proof_verifies_under_both_verifiers(toy_proofs):
    proof, root, jproof, jroot = toy_proofs
    _, pub = toy_inputs([3])
    air = ProdAir()
    # the JAX proof under the port's verifier
    ported = convert.proof_from_numpy(convert.proof_to_numpy(jproof),
                                      p254=True)
    assert bool(stark.verify(air, ported, F.fp(pub), TOY_PO2, root, TOY_PS))
    # the port's proof under the JAX verifier
    jps = JSTARK.ProofSystem(queries=4, fri_min_degree=8, commit_expand=2,
                             hash="poseidon254")
    flat = convert.proof_to_numpy(proof)
    jproof2 = jax_proof(flat)
    assert bool(JSTARK.verify(_jax_toy_air(), jproof2, JF.fp(pub), TOY_PO2,
                              jroot, jps))


def jax_proof(flat):
    """A flat proof dict -> the JAX package's SegmentProof (jnp arrays)."""
    from boundless_tpu.core import fri as JFRI

    def get(k):
        return jnp.asarray(flat[k]) if k in flat else None

    def opening(name):
        if f"{name}.rows" not in flat:
            return None
        return JSTARK.GroupOpening(get(f"{name}.rows"), get(f"{name}.paths"))

    def lst(name):
        keys = sorted((k for k in flat if k.startswith(
            f"fri_proof.{name}.")), key=lambda k: int(k.rsplit(".", 1)[1]))
        return tuple(get(k) for k in keys)

    fields = {}
    for name in JSTARK.SegmentProof._fields:
        if name.startswith("open_"):
            fields[name] = opening(name)
        elif name == "fri_proof":
            fields[name] = JFRI.FriProof(
                lst("round_roots"), lst("round_rows"), lst("round_paths"),
                get("fri_proof.final_coeffs"))
        else:
            fields[name] = get(name)
    return JSTARK.SegmentProof(**fields)


def test_toy_proof_tampers_and_the_other_suite_are_refused(toy_proofs):
    proof, root, _, _ = toy_proofs
    air = ProdAir()
    _, pub = toy_inputs([3])
    assert not bool(stark.verify(air, proof, F.fp(np.array([4])), TOY_PO2,
                                 root, TOY_PS))
    taps = proof.taps_data.clone()
    taps[0, 0, 0] = (taps[0, 0, 0] + 1) % F.P
    assert not bool(stark.verify(air, proof._replace(taps_data=taps),
                                 F.fp(pub), TOY_PO2, root, TOY_PS))
    # a poseidon2-suite verifier must not accept a p254 proof
    ps_bb = dataclasses.replace(TOY_PS, hash="poseidon2")
    root_bb = stark.control_root_of(air, TOY_PO2, ps=ps_bb, device="cpu")
    assert not bool(stark.verify(air, proof, F.fp(pub), TOY_PO2, root_bb,
                                 ps_bb))


# -- the CUDA source on emulated threads ------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = cuda_emu_build.build("poseidon254.cu",
                               tmp_path_factory.mktemp("emu254"))
    P254K.bind(lib)
    table = P254K.schedule_table()
    assert lib.bt_p254_table_words() == table.size
    assert lib.bt_p254_tree_top() == P254K.TREE_TOP
    assert lib.bt_p254_set_constants(table.ctypes.data) == 0
    return lib


def emulated_rows(lib, c, lanes):
    n, cols = c.shape
    mont = np.ascontiguousarray(F.mont_np(c).astype(np.uint32))
    out = np.zeros((n, 8), dtype=np.uint32)
    assert lib.bt_p254_rows(mont.ctypes.data if cols else None, n, cols,
                            lanes, out.ctypes.data, None) == 0
    return out


@pytest.mark.parametrize("n,cols", [(64, 48), (64, 64), (3, 0), (5, 1),
                                    (7, 17), (4, 24), (4, 16)])
def test_cuda_source_rows_on_emulated_threads(emulated, n, cols):
    c = canon((n, cols), 100 + cols)
    np.testing.assert_array_equal(emulated_rows(emulated, c, 1),
                                  P254.hash_rows_np(c.astype(np.uint32)))


# 13 rows leave the second warp's groups mostly idle; 45 rows end in a
# second, ragged block (40 hashes a block of 128 threads); 130 rows at one
# thread a hash end in a ragged second block too.
@pytest.mark.parametrize("lanes,n,cols", [(3, 13, 17), (3, 3, 0),
                                          (3, 45, 48), (3, 1, 64),
                                          (1, 130, 9)])
def test_cuda_source_rows_in_each_layout_on_emulated_threads(
        emulated, lanes, n, cols):
    c = canon((n, cols), 200 + n + cols)
    np.testing.assert_array_equal(emulated_rows(emulated, c, lanes),
                                  P254.hash_rows_np(c.astype(np.uint32)))


def test_cuda_source_pairs_on_emulated_threads(emulated):
    d = P254.hash_rows_np(canon((64, 3), 5).astype(np.uint32))
    inp = np.ascontiguousarray(d.reshape(32, 16))
    out = np.zeros((32, 8), dtype=np.uint32)
    assert emulated.bt_p254_pairs(inp.ctypes.data, 32, 1, out.ctypes.data,
                                  None) == 0
    np.testing.assert_array_equal(out, P254.hash_pairs_np(d[0::2], d[1::2]))


@pytest.mark.parametrize("m", [1, 11, 23])
def test_cuda_source_pairs_in_lanes_on_emulated_threads(emulated, m):
    d = P254.hash_rows_np(canon((2 * m, 3), 50 + m).astype(np.uint32))
    inp = np.ascontiguousarray(d.reshape(m, 16))
    out = np.zeros((m, 8), dtype=np.uint32)
    assert emulated.bt_p254_pairs(inp.ctypes.data, m, 3, out.ctypes.data,
                                  None) == 0
    np.testing.assert_array_equal(out, P254.hash_pairs_np(d[0::2], d[1::2]))


@pytest.mark.parametrize("m", [2, 8, P254K.TREE_TOP])
def test_cuda_source_tree_top_on_emulated_threads(emulated, m):
    level = np.ascontiguousarray(
        P254.hash_rows_np(canon((m, 2), 60 + m).astype(np.uint32)))
    out = np.zeros((m - 1, 8), dtype=np.uint32)
    assert emulated.bt_p254_tree(level.ctypes.data, m, out.ctypes.data,
                                 None) == 0
    want, cur = [], level
    while cur.shape[0] > 1:
        cur = P254.hash_pairs_np(cur[0::2], cur[1::2])
        want.append(cur)
    np.testing.assert_array_equal(out, np.concatenate(want))
    assert emulated.bt_p254_tree(level.ctypes.data, 3, out.ctypes.data,
                                 None) != 0  # not a power of two


def test_cuda_source_path_walk_on_emulated_threads(emulated):
    """Eleven opened paths of a 16-leaf tree (a ragged second warp), each
    walked to the root in one launch, against hash_paths' CPU route."""
    m = F.fp(canon((16, 3), 70))
    tree = suites.get("poseidon254").commit(m)
    from boundless_tpu_torch.core import merkle

    idx = torch.tensor([0, 1, 2, 5, 6, 9, 10, 11, 14, 15, 7],
                       dtype=torch.int64)
    rows, paths = merkle.open_rows(tree, idx)
    leaves = P254K.hash_rows(rows)
    want = P254K.words_np(P254K.hash_paths(leaves, idx, paths))
    assert (want == P254K.words_np(tree.root)[None]).all()
    lv = np.ascontiguousarray(P254K.words_np(leaves))
    sib = np.ascontiguousarray(P254K.words_np(paths))
    ix = np.ascontiguousarray(idx.numpy())
    out = np.zeros((11, 8), dtype=np.uint32)
    assert emulated.bt_p254_paths(lv.ctypes.data, ix.ctypes.data,
                                  sib.ctypes.data, 11, 4, out.ctypes.data,
                                  None) == 0
    np.testing.assert_array_equal(out, want)


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [16, 24, 48, 64])
def test_kernel_equals_plain_on_the_card(cols):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    m = F.fp(canon((1 << 10, cols), cols))
    got = P254K.hash_rows(m.cuda())
    np.testing.assert_array_equal(P254K.words_np(got),
                                  P254K.words_np(P254K.hash_rows(m)))
    pairs = got.view(-1, 16)
    np.testing.assert_array_equal(
        P254K.words_np(P254K.hash_level(pairs)),
        P254K.words_np(P254K.hash_level(pairs.cpu())))
