"""Port parity: the plain sponge against the reference's v1 Pallas sponge
(`_sponge_t`, interpret mode) at N = 256. Exact equality.

The interpret-mode v1 sponge takes up to 15 s per input shape on a
CPU (about 30 s for this file), so N = 256 and N = 512 live in files of
their own: the tier-1 run spreads tests over workers file by file
(`--dist loadfile`), and one file holding both would take about a
minute on one worker, test_torch_poseidon2.py holding them about a
minute and a half."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import poseidon2_pallas as JP2K
from boundless_tpu_torch.core import poseidon2 as P2

N = 256


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


@pytest.mark.parametrize("cols", [0, 5, 16, 40])
def test_hash_rows_equals_pallas_v1(cols):
    x = words((N, cols), cols)
    got = P2.hash_rows(torch.from_numpy(x.astype(np.int32)))
    want = JP2K.hash_rows(jnp.asarray(x.astype(np.uint32)), interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def test_hash_pairs_equals_pallas_v1():
    left, right = words((N, 8), 1), words((N, 8), 2)
    got = P2.hash_pair(torch.from_numpy(left.astype(np.int32)),
                       torch.from_numpy(right.astype(np.int32)))
    want = JP2K.hash_pairs(jnp.asarray(left.astype(np.uint32)),
                           jnp.asarray(right.astype(np.uint32)),
                           interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
