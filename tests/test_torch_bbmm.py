"""Port parity: the chunked exact weighted sums against JAX's int8-limb
MXU sums (`core/bbmm.py`), bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import bbmm as JB
from boundless_tpu.core import field as JF
from boundless_tpu_torch.core import bbmm as B


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
