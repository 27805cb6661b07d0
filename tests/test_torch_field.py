"""Port parity: boundless_tpu_torch.core.field against the JAX field.

Seeded numpy inputs go through both packages; every result must be equal
word for word (all values are field elements: the tolerance is zero)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu_torch.core import field as F

RNG_SEED = 11
EDGES = np.array([0, 1, 2, JF.P - 1, JF.P - 2, JF.R_MOD_P, JF.P // 2],
                 dtype=np.int64)


def words(shape, seed=RNG_SEED):
    """Seeded Montgomery words with the edge values up front."""
    w = np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                             dtype=np.int64)
    flat = w.reshape(-1)
    flat[: min(len(EDGES), flat.size)] = EDGES[: flat.size]
    return w


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def test_constants_match():
    assert F.P == JF.P and F.GENERATOR == JF.GENERATOR
    assert F.R_MOD_P == JF.R_MOD_P and F.ONE == JF.ONE
    assert F.ROU_FWD == JF.ROU_FWD and F.ROU_REV == JF.ROU_REV
    assert F.ROU_FWD_27 == JF.ROU_FWD_27
    assert F.mont(12345) == JF.mont(12345)
    assert F.unmont(F.mont(987)) == 987


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    a, b = words((4096,), 1), words((4096,), 2)
    b[: len(EDGES)] = EDGES[::-1]
    same(getattr(F, op)(t(a), t(b)), getattr(JF, op)(j(a), j(b)))


def test_neg_and_broadcast_scalar():
    a = words((1000,))
    same(F.neg(t(a)), JF.neg(j(a)))
    c = F.const(7)
    same(F.mul(t(a), c), JF.mul(j(a), jnp.uint32(JF.mont(7))))


def test_mont_roundtrip_and_fp():
    a = words((2000,), 3)
    same(F.to_mont(t(a)), JF.to_mont(j(a)))
    same(F.from_mont(t(a)), JF.from_mont(j(a)))
    canon = np.arange(-5, 300) * 7919
    same(F.fp(canon), JF.fp(canon))


def test_inv_pow_const():
    a = words((512,), 4)
    same(F.inv(t(a)), JF.inv(j(a)))
    for e in (0, 1, 2, 7, 12345, JF.P - 2):
        same(F.pow_const(t(a), e), JF.pow_const(j(a), e))


def test_sum_mod():
    a = words((37, 9), 5)
    for dim in (0, 1):
        same(F.sum_mod(t(a), dim), JF.sum_mod(j(a), axis=dim))


def test_ext_mul_inv_pow():
    a, b = words((300, 4), 6), words((300, 4), 7)
    a[0] = 0  # ext_inv(0) = 0 in both
    same(F.ext_mul(t(a), t(b)), JF.ext_mul(j(a), j(b)))
    same(F.ext_inv(t(a)), JF.ext_inv(j(a)))
    for e in (0, 1, 5, 4096 + 3):
        same(F.ext_pow_const(t(b), e), JF.ext_pow_const(j(b), e))


def test_ext_embed_and_scale():
    a, s = words((64, 4), 8), words((64,), 9)
    same(F.ext_from_base(t(s)), JF.ext_from_base(j(s)))
    same(F.ext_scale(t(a), t(s)), JF.ext_scale(j(a), j(s)))
    same(F.ext_ones((3,)), JF.ext_ones((3,)))
    coeffs = np.array([[1, 2, 3, 4], [-1, 0, 11, 5]])
    same(F.ext(coeffs), JF.ext(coeffs))
