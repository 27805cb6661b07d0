"""The port's BN254 curve, pairing, Groth16 engines, CRS file and EVM seal.

The cases of `tests/test_groth16.py`, `test_pairing_groth16.py`,
`test_groth16_crs.py` and `test_evm.py`, run on the port's copies
(`boundless_tpu_torch/groth16/`), and the port against the JAX package:
with a fixed random source both packages' trapdoor and CRS provers give
the same A, B and C on the same system (the CRS prover's MSMs through the
host Pippenger and through the card's plain version), a `.btzk` written
by either loads in the other, and seal calldata is byte-equal. Tolerance
0: exact group arithmetic.
"""

import dataclasses
import random

import pytest
import torch

from boundless_tpu.groth16 import bn254 as JBN
from boundless_tpu.groth16 import crs as JCRS
from boundless_tpu.groth16 import evm as JEVM
from boundless_tpu.groth16 import protocol as JPROTO
from boundless_tpu.groth16 import qap as JQAP
from boundless_tpu.groth16 import r1cs as JR1
from boundless_tpu_torch import convert
from boundless_tpu_torch.groth16 import crs, evm, msm, msm_device
from boundless_tpu_torch.groth16 import pairing as PR
from boundless_tpu_torch.groth16 import protocol as GP
from boundless_tpu_torch.groth16 import qap, r1cs
from boundless_tpu_torch.groth16.bn254 import G1, P, R


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def fixed_rng(seed):
    r = random.Random(seed)
    return lambda n: r.randrange(1, n)


# -- the curve (tests/test_groth16.py) ---------------------------------------


def test_generator_on_curve_and_order():
    g = G1.generator()
    x, y = g.to_affine()
    assert (y * y - x * x * x - 3) % P == 0
    assert g.mul(R).is_infinity()
    assert not g.mul(R - 1).is_infinity()


def test_group_law():
    g = G1.generator()
    a, b, c = g.mul(123456789), g.mul(987654321), g.mul(31337)
    assert a.add(b).eq(g.mul(123456789 + 987654321))
    assert a.add(a).eq(a.double())
    assert a.add(a.neg()).is_infinity()
    assert a.add(G1.infinity()).eq(a)
    assert a.add(b).add(c).eq(a.add(b.add(c)))
    assert a.add(b).eq(b.add(a))
    assert G1.from_affine(g.mul(42).to_affine()).eq(g.mul(42))


@pytest.mark.parametrize("window", [4, 8])
def test_msm_pippenger_matches_naive(window):
    rng = random.Random(5)
    g = G1.generator()
    points = [g.mul(rng.randrange(1, 10**9)) for _ in range(17)]
    scalars = [rng.randrange(0, R) for _ in range(17)]
    assert msm.msm_pippenger(points, scalars, window_bits=window).eq(
        msm.msm_naive(points, scalars))


def test_msm_edge_cases():
    g = G1.generator()
    assert msm.msm_pippenger([], []).is_infinity()
    assert msm.msm_pippenger([g], [0]).is_infinity()
    assert msm.msm_pippenger([g, g], [1, R - 1]).is_infinity()


@pytest.mark.parametrize("k", [1, 2, 12345, R - 1])
def test_scalar_mul_equals_jax(k):
    assert G1.generator().mul(k).to_affine() == \
        JBN.G1.generator().mul(k).to_affine()


# -- the pairing (tests/test_pairing_groth16.py) ------------------------------


def test_tower_field_axioms():
    rng = random.Random(11)

    def rnd2():
        return (rng.randrange(PR.P), rng.randrange(PR.P))

    a, b, c = rnd2(), rnd2(), rnd2()
    assert PR.f2_mul(a, PR.f2_add(b, c)) == PR.f2_add(
        PR.f2_mul(a, b), PR.f2_mul(a, c))
    assert PR.f2_mul(a, PR.f2_inv(a)) == PR.F2_ONE
    a6 = (rnd2(), rnd2(), rnd2())
    assert PR.f6_mul(a6, PR.f6_inv(a6)) == PR.F6_ONE
    a12 = ((rnd2(), rnd2(), rnd2()), (rnd2(), rnd2(), rnd2()))
    assert PR.f12_mul(a12, PR.f12_inv(a12)) == PR.F12_ONE


def test_g2_group_law():
    g2 = PR.g2_generator()
    assert PR.g2_is_on_curve(g2)
    a = PR.g2_mul(g2, 123456789)
    b = PR.g2_mul(g2, 987654321)
    assert PR.g2_add(a, b) == PR.g2_mul(g2, 123456789 + 987654321)
    assert PR.g2_add(a, PR.g2_neg(a)) is None
    assert PR.g2_mul(g2, R) is None


def test_pairing_bilinear_and_equal_to_jax():
    from boundless_tpu.groth16 import pairing as JPR

    g1, g2 = G1.generator(), PR.g2_generator()
    e = PR.pairing(g1, g2)
    assert e != PR.F12_ONE
    assert PR.f12_pow(e, R) == PR.F12_ONE
    assert PR.pairing(g1.mul(6), PR.g2_mul(g2, 7)) == PR.f12_pow(e, 42)
    assert PR.pairing(G1.infinity(), g2) == PR.F12_ONE
    assert e == JPR.pairing(JBN.G1.generator(), JPR.g2_generator())


def test_groth16_end_to_end():
    r1cs_ = GP.mul_circuit()
    x, y = 1234567, 7654321
    z = x * y % R
    s = [1, z, x, y, x * y % R]
    assert r1cs_.is_satisfied(s)
    pk, vk = GP.setup(r1cs_)
    proof = GP.prove(r1cs_, pk, s)
    assert GP.verify(vk, proof, [z])
    assert not GP.verify(vk, proof, [(z + 1) % R])
    assert not GP.verify(vk, GP.Proof(a=proof.a.mul(2), b=proof.b,
                                      c=proof.c), [z])
    p2 = GP.prove(r1cs_, pk, s)
    assert not (p2.a.eq(proof.a) and p2.c.eq(proof.c))
    assert GP.verify(vk, p2, [z])
    with pytest.raises(AssertionError, match="does not satisfy"):
        GP.prove(r1cs_, pk, [1, 99, 2, 3, 7])


# -- the sparse engines and the CRS file (tests/test_groth16_crs.py) ----------


def toy_system(mod):
    """z = x*y public; w*w = w2 for QAP headroom (either package's r1cs)."""
    b = mod.Builder(concrete=True)
    z = b.pub_var(15)
    x, y, w, w2 = b.wit(3), b.wit(5), b.wit(7), b.wit(49)
    b.enforce(b.lc(x), b.lc(y), b.lc(z))
    b.enforce(b.lc(w), b.lc(w), b.lc(w2))
    return b.to_sparse(), b.witness()


def wide_system(mod, n=40):
    """A chain of products, wide enough (> 64 variables) that the CRS
    prover's MSMs reach the card's Pippenger."""
    vals = [3]
    for i in range(n):
        vals.append(vals[-1] * (i + 2) % R)
    b = mod.Builder(concrete=True)
    out = b.pub_var(vals[-1])
    cur = b.lc(b.wit(vals[0]))
    for i in range(n):
        nxt = b.wit(vals[i + 1])
        b.enforce(cur, b.const_lc(i + 2), b.lc(nxt))
        sq = b.wit(vals[i + 1] * vals[i + 1] % R)
        b.enforce(b.lc(nxt), b.lc(nxt), b.lc(sq))
        cur = b.lc(nxt)
    b.enforce(cur, b.const_lc(1), b.lc(out))
    return b.to_sparse(), b.witness()


def test_msm_prover_and_crs_roundtrip(tmp_path):
    sys_, s = toy_system(r1cs)
    pk, vk = qap.setup_sparse(sys_)
    proof = qap.prove_sparse(sys_, pk, s, check=True, device="cpu")
    assert GP.verify(vk, proof, s[1: 1 + sys_.n_pub])
    path = str(tmp_path / "wrap.btzk")
    crs.save_crs(path, pk, vk, crs.CrsMeta(n_rows=len(sys_.rows),
                                           n_vars=sys_.n_vars,
                                           n_pub=sys_.n_pub))
    pk2, vk2, meta = crs.load_crs(path)
    assert (meta.n_rows, meta.n_vars, meta.n_pub) == (
        len(sys_.rows), sys_.n_vars, sys_.n_pub)
    proof2 = qap.prove_sparse(sys_, pk2, s, check=True, device="cpu")
    assert GP.verify(vk2, proof2, s[1: 1 + sys_.n_pub])
    assert GP.verify(vk2, proof, s[1: 1 + sys_.n_pub])


def test_trapdoor_prover_refuses_a_tampered_public():
    sys_, s = toy_system(r1cs)
    td, vk = qap.setup_trapdoor(sys_)
    p_td = qap.prove_with_trapdoor(sys_, td, s, check=True)
    assert GP.verify(vk, p_td, s[1: 1 + sys_.n_pub])
    assert not GP.verify(vk, p_td, [(s[1] + 1) % R])


def proof_ints(p):
    return convert.groth16_to_ints(p)


def test_trapdoor_proofs_equal_jax():
    sys_, s = toy_system(r1cs)
    jsys, js = toy_system(JR1)
    td, vk = qap.setup_trapdoor(sys_, rng=fixed_rng(1))
    jtd, jvk = JQAP.setup_trapdoor(jsys, rng=fixed_rng(1))
    assert convert.groth16_to_ints(vk) == convert.groth16_to_ints(jvk)
    p = qap.prove_with_trapdoor(sys_, td, s, rng=fixed_rng(2))
    jp = JQAP.prove_with_trapdoor(jsys, jtd, js, rng=fixed_rng(2))
    assert proof_ints(p) == proof_ints(jp)


@pytest.mark.parametrize("msm_route", ["host", "plain"])
def test_crs_prover_proofs_equal_jax(msm_route, monkeypatch):
    """setup_sparse/prove_sparse with a fixed rng: the same A, B, C as
    JAX's, with the MSMs on the host Pippenger (the CPU dispatch) or on
    the card's plain version (msm_device on a CPU tensor)."""
    sys_, s = wide_system(r1cs)
    jsys, js = wide_system(JR1)
    assert sys_.n_vars > qap.PIPPENGER_MIN_POINTS
    pk, vk = qap.setup_sparse(sys_, rng=fixed_rng(3))
    jpk, jvk = JQAP.setup_sparse(jsys, rng=fixed_rng(3))
    assert convert.groth16_to_ints(pk) == convert.groth16_to_ints(jpk)
    if msm_route == "plain":
        monkeypatch.setattr(qap, "msm_pippenger", lambda pts, sc, device:
                            msm_device.msm(pts, sc, "cpu"))
    p = qap.prove_sparse(sys_, pk, s, rng=fixed_rng(4), device="cpu")
    jp = JQAP.prove_sparse(jsys, jpk, js, rng=fixed_rng(4))
    assert proof_ints(p) == proof_ints(jp)
    assert GP.verify(vk, p, s[1: 1 + sys_.n_pub])
    assert JPROTO.verify(jvk, convert.groth16_from_ints(
        JPROTO.Proof, proof_ints(p), JBN.G1), js[1: 1 + jsys.n_pub])


def test_prove_sparse_defaults_to_the_card():
    sys_, s = toy_system(r1cs)
    pk, _ = qap.setup_sparse(sys_, rng=fixed_rng(5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qap.prove_sparse(sys_, pk, s)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_btzk_files_load_across_packages(tmp_path, writer):
    sys_, _ = toy_system(r1cs)
    jsys, _ = toy_system(JR1)
    path = str(tmp_path / "x.btzk")
    if writer == "jax":
        pk, vk = JQAP.setup_sparse(jsys, rng=fixed_rng(6))
        JCRS.save_crs(path, pk, vk, JCRS.CrsMeta(len(jsys.rows),
                                                  jsys.n_vars, jsys.n_pub))
        pk2, vk2, meta = crs.load_crs(path)
        other = str(tmp_path / "y.btzk")
        crs.save_crs(other, pk2, vk2, meta)
    else:
        pk, vk = qap.setup_sparse(sys_, rng=fixed_rng(6))
        crs.save_crs(path, pk, vk, crs.CrsMeta(len(sys_.rows), sys_.n_vars,
                                               sys_.n_pub))
        pk2, vk2, meta = JCRS.load_crs(path)
        other = str(tmp_path / "y.btzk")
        JCRS.save_crs(other, pk2, vk2, meta)
    assert convert.groth16_to_ints(pk2) == convert.groth16_to_ints(pk)
    assert convert.groth16_to_ints(vk2) == convert.groth16_to_ints(vk)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def test_groth16_converters_round_trip():
    sys_, s = toy_system(r1cs)
    pk, vk = qap.setup_sparse(sys_, rng=fixed_rng(7))
    p = qap.prove_sparse(sys_, pk, s, rng=fixed_rng(8), device="cpu")
    for obj, cls in ((p, GP.Proof), (vk, GP.VerifyingKey),
                     (pk, GP.ProvingKey)):
        back = convert.groth16_from_ints(cls, convert.groth16_to_ints(obj))
        assert convert.groth16_to_ints(back) == convert.groth16_to_ints(obj)


# -- the EVM seal (tests/test_evm.py) ----------------------------------------


@dataclasses.dataclass
class FakeSeal:
    proof: object
    vk: object
    publics: tuple


@dataclasses.dataclass
class FakeReceipt:
    kind: str
    dev_mode: bool
    inner: object


def wrap_like_receipt(mod_r1cs, mod_qap, mod_proto):
    """A three-public circuit (x * y = z) proved by the CRS prover."""
    bld = mod_r1cs.Builder(concrete=True)
    x, y, z = bld.pub_var(11), bld.pub_var(31), bld.pub_var(341)
    xy = bld.mul(bld.lc(x), bld.lc(y))
    bld.enforce_zero({**xy, z: (mod_r1cs.FR - 1) % mod_r1cs.FR})
    sys_ = bld.to_sparse()
    pk, vk = mod_qap.setup_sparse(sys_, rng=fixed_rng(3))
    kw = {"device": "cpu"} if mod_qap is qap else {}
    proof = mod_qap.prove_sparse(sys_, pk, bld.witness(), rng=fixed_rng(4),
                                 **kw)
    assert mod_proto.verify(vk, proof, [11, 31, 341])
    seal = FakeSeal(proof=proof, vk=vk, publics=(11, 31))
    return FakeReceipt(kind="groth16", dev_mode=False, inner=seal), vk


def test_seal_calldata_roundtrip_and_byte_equal_to_jax():
    receipt, vk = wrap_like_receipt(r1cs, qap, GP)
    jreceipt, _ = wrap_like_receipt(JR1, JQAP, JPROTO)
    data = evm.encode_seal(receipt)
    assert data == JEVM.encode_seal(jreceipt)
    assert len(data) == 4 + 10 * 32
    assert data[:4] == bytes.fromhex("73c457ba")
    a_aff = receipt.inner.proof.a.to_affine()
    assert data[4:36] == int(a_aff[0]).to_bytes(32, "big")
    dec = evm.decode_seal(data)
    assert dec.a == a_aff and dec.publics == (11, 31)
    assert dec.b == receipt.inner.proof.b
    a = G1(dec.a[0], dec.a[1], 1)
    c = G1(dec.c[0], dec.c[1], 1)
    assert GP.verify(vk, GP.Proof(a=a, b=dec.b, c=c), [11, 31, 341])
    bad = bytearray(data)
    bad[40] ^= 1
    dec2 = evm.decode_seal(bytes(bad))
    assert not GP.verify(vk, GP.Proof(a=G1(dec2.a[0], dec2.a[1], 1),
                                      b=dec2.b, c=c), [11, 31, 341])


def test_generated_verifier_equals_jax():
    receipt, vk = wrap_like_receipt(r1cs, qap, GP)
    jreceipt, jvk = wrap_like_receipt(JR1, JQAP, JPROTO)
    src = evm.generate_verifier(vk, allowed_root_felt=12345)
    assert src == JEVM.generate_verifier(jvk, allowed_root_felt=12345)
    alpha = vk.alpha_g1.to_affine()
    assert f"uint256 constant alphax = {alpha[0]};" in src
    assert "CONTROL_ROOT_FELT = 12345;" in src


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        evm.decode_seal(b"\x00" * 100)
    with pytest.raises(ValueError):
        evm.decode_seal(bytes(4 + 320))
