"""Port parity: the four-step NTT (CUDA kernel glue) on its plain sub-NTT.

On the CPU `kernels/ntt.sub_ntt` runs its plain version, so the port's
`ntt_four_step` here exercises the glue the card runs (splits, mid-twiddle
tables, transposed stores, recursion) around the plain sub-transform. It
must equal the JAX package's `ntt_pallas.ntt_four_step` in interpret mode
(as tests/test_ntt_pallas.py runs it) and the port's Stockham, word for
word (field elements: tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import ntt_pallas as JNP
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import ntt as NK


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, F.P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("n,c", [(1 << 12, 3), (1 << 13, 2)])
@pytest.mark.parametrize("forward", [True, False])
def test_four_step_matches_jax_and_stockham(n, c, forward):
    x = words((n, c), n + c)
    got = NTT.ntt_four_step(t(x), forward)
    want = JNP.ntt_four_step(jnp.asarray(x.astype(np.uint32)), forward)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    assert torch.equal(got, NTT.stockham(t(x), forward))


def test_four_step_one_dim_and_roundtrip():
    x = t(words((1 << 12,), 5))
    y = NTT.ntt_four_step(x, True)
    assert torch.equal(y, NTT.stockham(x, True))
    n_inv = F.const(pow(1 << 12, F.P - 2, F.P))
    assert torch.equal(F.mul(NTT.ntt_four_step(y, False), n_inv), x)


def test_four_step_recurses_past_one_level():
    """N > MAX_M^2: the second sub-transform is itself a four-step."""
    n = NK.MAX_M * NK.MAX_M * 2
    assert NTT._split(n)[1] > NK.MAX_M
    x = t(words((n, 1), 9))
    assert torch.equal(NTT.ntt_four_step(x, True), NTT.stockham(x, True))


@pytest.mark.parametrize("m,lanes,n2", [(1, 3, 1), (2, 5, 5), (64, 12, 4),
                                        (NK.MAX_M, 6, 3)])
def test_plain_sub_ntt_with_mid_twiddles(m, lanes, n2):
    """The plain version of the kernel's fused store: NTT along axis 0,
    times mid[k1, j], transposed to (n2, m * lanes / n2)."""
    x = t(words((m, lanes), m))
    mid = t(words((m, n2), lanes))
    got = NK.sub_ntt(x, True, mid)
    y = NTT.stockham(x, True).reshape(m, n2, lanes // n2)
    want = torch.stack([F.mul(y[:, j], mid[:, j, None]).reshape(-1)
                        for j in range(n2)])
    assert torch.equal(got, want)
    assert torch.equal(NK.sub_ntt(x, False), NTT.stockham(x, False))


def test_ntt_dispatch_on_cpu_is_stockham():
    x = t(words((1 << 11, 2), 4))
    before = NK.LAUNCHES
    assert torch.equal(NTT.ntt(x), NTT.stockham(x))
    assert NK.LAUNCHES == before  # plain versions count no launch


def test_mid_twiddles_match_jax():
    for n1, n2, forward in ((64, 64, True), (32, 128, False)):
        got = NTT._mid_twiddles(n1, n2, forward, torch.device("cpu"))
        np.testing.assert_array_equal(
            got.numpy().astype(np.int64),
            JNP._mid_twiddles(n1, n2, forward).astype(np.int64))
        np.testing.assert_array_equal(
            NK._flat_twiddles(n1, forward).astype(np.int64),
            JNP._stage_tables_flat(n1, forward).ravel().astype(np.int64))
