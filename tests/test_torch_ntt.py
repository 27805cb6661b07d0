"""Port parity: boundless_tpu_torch.core.ntt against the JAX NTT/LDE.

Seeded inputs, exact equality (field elements)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import ntt as JNTT
from boundless_tpu_torch.core import ntt as NTT


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(a.astype(np.int32))


def j(a):
    return jnp.asarray(a.astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (2, 3), (64, 5), (256, 4, 2)])
@pytest.mark.parametrize("forward", [True, False])
def test_ntt(shape, forward):
    x = words(shape, shape[0])
    same(NTT.ntt(t(x), forward), JNTT.ntt(j(x), forward))


def test_intt_interpolate():
    x = words((128, 3), 1)
    same(NTT.intt(t(x)), JNTT.intt(j(x)))
    same(NTT.interpolate(t(x)), JNTT.interpolate(j(x)))


@pytest.mark.parametrize("expand", [1, 2, 4])
def test_coset_evaluate_interpolate(expand):
    c = words((32, 6), 2)
    ev = NTT.coset_evaluate(t(c), expand)
    same(ev, JNTT.coset_evaluate(j(c), expand))
    same(NTT.coset_interpolate(ev, expand),
         JNTT.coset_interpolate(j(ev.numpy().astype(np.int64)), expand))


def test_ext_powers_and_evals():
    z = words((4,), 3)
    same(NTT.ext_powers(t(z), 37), JNTT.ext_powers(j(z), 37))
    coeffs = words((64, 7), 4)
    same(NTT.eval_poly_ext(t(coeffs), t(z)),
         JNTT.eval_poly_ext(j(coeffs), j(z)))
    ecoeffs = words((50, 4), 5)
    same(NTT.eval_ext_poly_ext(t(ecoeffs), t(z)),
         JNTT.eval_ext_poly_ext(j(ecoeffs), j(z)))
