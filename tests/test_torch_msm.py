"""The card's BN254 MSM: limbs, plain torch curve arithmetic, the plain
Pippenger and the CUDA source, against the host curve and the JAX package.

`groth16/limbs.py` (8 x 32-bit Montgomery limbs) against Python ints;
`msm_device.ec_add`/`ec_double` against `bn254.G1` on the cases of
`tests/test_msm_tpu.py:18-37`; the plain MSM (`msm_device.msm` on the
CPU) against `msm.msm_naive` and the JAX package's host `msm_pippenger` at
n = 70 with the edge cases of `test_msm_tpu.py:55-70`; the prep's signed
digits (every scalar recomposed exactly, window 31 never carrying out),
bucket and chunk layout; `csrc/msm.cu` built by g++ against
`tests/cuda_emu.h` (emulated threads: chunks, buckets, bit slices,
windows) against the host Pippenger, with the signed digits' edge cases. A `cuda`-marked case holds
the kernel to its plain version on the card and skips here. Tolerance 0.
"""

import ctypes
import os
import random
import sys

import numpy as np
import pytest
import torch

from boundless_tpu.groth16 import bn254 as JBN
from boundless_tpu.groth16 import msm as JMSM
from boundless_tpu_torch.groth16 import limbs as LB
from boundless_tpu_torch.groth16 import msm as HM
from boundless_tpu_torch.groth16 import msm_device as MD
from boundless_tpu_torch.groth16 import qap
from boundless_tpu_torch.groth16.bn254 import G1, P, R
from boundless_tpu_torch.kernels import msm as MK

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import cuda_emu_build  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def limbs_of(xs):
    return LB.tensor(np.stack([LB.to_mont(x) for x in xs]))


def jac(points):
    """List[G1] -> (n, 3, 8) int64 Jacobian Montgomery limbs."""
    return torch.from_numpy(np.stack([MD.point_words(p) for p in points])
                            .astype(np.int64).reshape(-1, 3, 8))


def back(t):
    return [MD.point_from_words(w) for w in t.reshape(-1, 24).numpy()]


def edge_case_msm(n=70, seed=11):
    """tests/test_msm_tpu.py:55-70: zero scalars, one, duplicate digits, a
    point at infinity; plus a point and its negation with equal scalars
    (a bucket sum P + (-P)) and a repeated point (a doubling)."""
    rng = random.Random(seed)
    g = G1.generator()
    points = [g.mul(rng.randrange(1, 10**6)) for _ in range(n)]
    scalars = [rng.randrange(0, R) for _ in range(n)]
    scalars[3] = 0
    scalars[11] = 1
    scalars[12] = scalars[13] = 5
    points[20] = G1.infinity()
    points[30], scalars[30] = points[31], scalars[31]
    points[40], scalars[40] = points[41].neg(), scalars[41]
    return points, scalars


# -- limbs --------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_limbs_round_trip(seed):
    rng = random.Random(seed)
    for x in [0, 1, P - 1] + [rng.randrange(P) for _ in range(20)]:
        assert LB.from_limbs(LB.to_limbs(x)) == x
        assert LB.from_mont(LB.to_mont(x)) == x
        assert LB.from_limbs(LB.to_mont(x)) == x * (1 << 256) % P


@pytest.mark.parametrize("seed", range(3))
def test_limb_arithmetic_equals_python_ints(seed):
    rng = random.Random(100 + seed)
    xs = [rng.randrange(P) for _ in range(64)] + [0, 1, P - 1, P - 1]
    ys = [rng.randrange(P) for _ in range(64)] + [P - 1, 0, P - 1, 1]
    a, b = limbs_of(xs), limbs_of(ys)
    for op, ref in ((LB.mul, lambda x, y: x * y), (LB.add, lambda x, y: x + y),
                    (LB.sub, lambda x, y: x - y)):
        out = op(a, b)
        assert int(out.min()) >= 0 and int(out.max()) <= LB.MASK
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert LB.from_limbs(out[i].numpy()) < P
            assert LB.from_mont(out[i].numpy()) == ref(x, y) % P


# -- plain curve arithmetic (tests/test_msm_tpu.py:18-37) ---------------------


def test_ec_ops_match_host():
    g = G1.generator()
    a, b = g.mul(123457), g.mul(998877)
    d = back(MD.ec_double(jac([a, b, a, G1.infinity()])))
    assert d[0].eq(a.double()) and d[1].eq(b.double())
    assert d[3].is_infinity()
    s = back(MD.ec_add(jac([a, b, a, G1.infinity(), a]),
                       jac([b, a, a, a, G1.infinity()])))
    assert s[0].eq(a.add(b)) and s[1].eq(a.add(b))
    assert s[2].eq(a.double())
    assert s[3].eq(a) and s[4].eq(a)
    assert back(MD.ec_add(jac([a]), jac([a.neg()])))[0].is_infinity()


def test_affine_batch_and_point_words():
    g = G1.generator()
    pts = [g.mul(k) for k in (1, 5, 77)] + [G1.infinity(), g.mul(9).double()]
    assert MD.affine_batch(pts) == [p.to_affine() for p in pts]
    words = MD.points_words(pts)
    assert words.shape == (5, 16) and not words[3].any()
    for p in pts:
        assert MD.point_from_words(MD.point_words(p)).eq(p)


def test_device_points_are_cached_per_list():
    g = G1.generator()
    pts = [g.mul(k) for k in range(1, 6)]
    t = MD.device_points(pts, "cpu")
    assert MD.device_points(pts, "cpu") is t
    assert MD.device_points(list(pts), "cpu") is not t


# -- the prep -----------------------------------------------------------------


def test_prep_buckets_and_chunks():
    points, scalars = edge_case_msm()
    scalars = scalars + [7] * 100  # one bucket of 100 entries: 4 chunks
    pr = MD.prep(scalars, "cpu")
    digits = MD.signed_digits(scalars, "cpu")
    assert pr.idx.shape[0] == int((digits != 0).sum())
    assert int(pr.chunk_len.max()) <= MD.CHUNK
    assert int(pr.chunk_len.min()) >= 1
    assert int(pr.chunk_len.sum()) == pr.idx.shape[0]
    counts = torch.zeros(MD.WINDOWS * MD.BUCKETS, dtype=torch.int64)
    for b in range(MD.WINDOWS * MD.BUCKETS):
        c0, k = int(pr.bucket_chunk0[b]), int(pr.bucket_chunks[b])
        counts[b] = int(pr.chunk_len[c0: c0 + k].sum())
        for c in range(c0, c0 + k):  # every entry of the chunk is in b
            s, n = int(pr.chunk_start[c]), int(pr.chunk_len[c])
            for e in pr.idx[s: s + n].tolist():
                d = int(digits[~e if e < 0 else e, b // MD.BUCKETS])
                assert abs(d) == b % MD.BUCKETS + 1 and (d < 0) == (e < 0)
    mag = digits.abs()
    want = torch.bincount((mag - 1 + torch.arange(MD.WINDOWS) * MD.BUCKETS)
                          [mag != 0], minlength=MD.WINDOWS * MD.BUCKETS)
    assert torch.equal(counts, want)
    assert int(pr.bucket_chunks[6]) == 4  # window 0, |digit| 7


@pytest.mark.parametrize("seed", range(3))
def test_signed_digits_recompose_every_scalar(seed):
    """d_w in [-127, 128], sum_w d_w 256^w = s mod r, and window 31 never
    carries out (r's top byte is 0x30): no 33rd window."""
    rng = random.Random(200 + seed)
    top = [R - 1, R - 2, R, R + 1, 0, 1, 0x80, 0x81, (1 << 253) - 1,
           int.from_bytes(bytes([0x80] * 31), "little"),
           int.from_bytes(bytes([0xFF] * 31) + b"\x30", "little") % R]
    scalars = top + [rng.randrange(R) for _ in range(200)]
    d = MD.signed_digits(scalars, "cpu")
    assert d.shape == (len(scalars), MD.WINDOWS)
    assert int(d.min()) >= -127 and int(d.max()) <= 128
    assert int(d[:, -1].min()) >= 0  # window 31 takes a carry, makes none
    for s, row in zip(scalars, d.tolist()):
        assert sum(v << (8 * w) for w, v in enumerate(row)) == s % R
    assert 128 in d[9].tolist() and -127 in d[top.index(0x81)].tolist()


def test_chunk_length_grows_with_the_entries():
    assert MD.chunk_for(0) == MD.chunk_for(500 * 32) == MD.CHUNK
    big = (1 << 20) * MD.WINDOWS
    c = MD.chunk_for(big)
    assert c > MD.CHUNK
    mean = -(-big // (MD.WINDOWS * MD.BUCKETS))
    assert -(-mean // c) <= MD.BUCKET_CHUNKS


# -- the plain MSM ------------------------------------------------------------


def test_plain_msm_equals_naive_and_the_jax_host_pippenger():
    points, scalars = edge_case_msm()
    got = MD.msm(points, scalars, "cpu")
    assert got.eq(HM.msm_naive(points, scalars))
    jpoints = [JBN.G1.from_affine(p.to_affine()) for p in points]
    want = JMSM.msm_pippenger(jpoints, scalars)
    assert got.to_affine() == want.to_affine()


def test_plain_msm_small_cases():
    g = G1.generator()
    a = g.mul(12345)
    assert MD.msm([a, G1.infinity()], [0, 12345], "cpu").is_infinity()
    assert MD.msm([g, g], [1, R - 1], "cpu").is_infinity()
    assert MD.msm([], [], "cpu").is_infinity()
    assert MD.msm([a], [R + 3], "cpu").eq(a.mul(3))


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    """The CPU route is the wrapper's caller's (`msm_device.msm`): it runs
    the plain version and launches nothing; the wrapper itself takes CUDA
    tensors only."""
    points, scalars = edge_case_msm(n=50, seed=3)
    pts, pr = MD.device_points(points, "cpu"), MD.prep(scalars, "cpu")
    before = MK.LAUNCHES
    assert MD.msm(points, scalars, "cpu").eq(
        HM.msm_pippenger(points, scalars))
    assert MK.LAUNCHES == before
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        MK.pippenger(pts, pr)


def test_qap_dispatch_runs_the_host_pippenger_on_the_cpu():
    points, scalars = edge_case_msm()
    before = MK.LAUNCHES
    got = qap.msm_pippenger(points, scalars, "cpu")
    assert MK.LAUNCHES == before
    assert got.eq(HM.msm_pippenger(points, scalars))


# -- the CUDA source on emulated threads ------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = cuda_emu_build.build("msm.cu", tmp_path_factory.mktemp("emumsm"))
    vp = ctypes.c_void_p
    lib.bt_msm_run.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                               vp, vp, vp, vp]
    lib.bt_msm_buckets.restype = ctypes.c_int
    lib.bt_msm_slices.restype = ctypes.c_int
    return lib


def run_emulated(lib, points, scalars):
    pts = np.ascontiguousarray(MD.device_points(points, "cpu").numpy())
    pr = MD.prep(scalars, "cpu")
    arrs = [np.ascontiguousarray(x.numpy()) for x in (
        pr.idx, pr.chunk_start, pr.chunk_len, pr.bucket_chunk0,
        pr.bucket_chunks)]
    chunks = arrs[1].shape[0]
    partial = np.zeros((max(chunks, 1), 24), np.uint32)
    buckets = np.zeros((lib.bt_msm_buckets(), 24), np.uint32)
    slices = np.zeros((lib.bt_msm_slices(), 24), np.uint32)
    out = np.zeros(24, np.uint32)
    assert lib.bt_msm_run(pts.ctypes.data, arrs[0].ctypes.data,
                          arrs[1].ctypes.data, arrs[2].ctypes.data, chunks,
                          arrs[3].ctypes.data, arrs[4].ctypes.data,
                          partial.ctypes.data, buckets.ctypes.data,
                          slices.ctypes.data, out.ctypes.data, None) == 0
    return MD.point_from_words(out)


def test_cuda_source_on_emulated_threads(emulated):
    points, scalars = edge_case_msm()
    g = G1.generator()
    points += [g.mul(k) for k in range(2, 102)]
    scalars += [7] * 100  # a bucket of 100 entries: four chunks
    assert run_emulated(emulated, points, scalars).eq(
        HM.msm_pippenger(points, scalars))


def test_cuda_source_edge_cases_on_emulated_threads(emulated):
    g = G1.generator()
    assert run_emulated(emulated, [g, G1.infinity()], [0, 5]).is_infinity()
    assert run_emulated(emulated, [g, g.neg()], [9, 9]).is_infinity()
    assert run_emulated(emulated, [g, g], [3, 3]).eq(g.mul(6))


def test_cuda_source_signed_digit_edge_cases_on_emulated_threads(emulated):
    """Scalars 0, 1 and r - 1, digits of exactly 128 and -127, a point and
    its negation in one bucket (P + -P: infinity), P and P in one bucket
    through opposite signs (a doubling), the point at infinity."""
    rng = random.Random(9)
    g = G1.generator()
    points = [g.mul(rng.randrange(1, 10**6)) for _ in range(24)]
    scalars = [rng.randrange(R) for _ in range(24)]
    scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
    scalars[3] = int.from_bytes(bytes([0x80] * 31), "little")
    scalars[4] = int.from_bytes(bytes([0x81] * 31), "little")
    points[5] = G1.infinity()
    points[6], scalars[6] = points[7].neg(), scalars[7]
    points[8], scalars[8] = points[9], R - scalars[9]
    points[10], scalars[10] = points[11], scalars[11]
    assert run_emulated(emulated, points, scalars).eq(
        HM.msm_pippenger(points, scalars))
    assert run_emulated(emulated, [g, g], [1, R - 1]).is_infinity()
    assert run_emulated(emulated, [g] * 3, [0x80] * 3).eq(g.mul(3 * 0x80))


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    points, scalars = edge_case_msm()
    pts = MD.device_points(points, dev)
    pr = MD.prep(scalars, dev)
    got = MK.pippenger(pts, pr)
    want = MD.plain_pippenger(pts, pr)
    assert MD.point_from_words(got.cpu().numpy()).eq(
        MD.point_from_words(want.cpu().numpy()))
    assert MD.msm(points, scalars, dev).eq(HM.msm_pippenger(points, scalars))
