"""Port parity: the redesigned NTT sub-transform and the glue it folds in.

1. The kernel's schedule (`kernels/ntt.radix_passes`: a mixed-radix
   Stockham, R elements a thread, one (m,) power table read at the pass
   and stage twiddle indices), run here in numpy pass by pass as
   `csrc/ntt.cu` runs it, equals the port's radix-2 Stockham for every
   size the kernel takes and both directions.
2. The one table the kernel reads, `kernels/ntt.pow_table`, at the radix-2
   stage indices equals the stage twiddles it replaces
   (`core/ntt._stage_twiddles`).
3. The CUDA route of the LDE glue (`core/ntt._fused`: the zero tail and
   g^i on the first launch's load, 1/N and g^-k on the last launch's
   store, the row cut), here through `sub_ntt_plain` and its options,
   equals the JAX package's `coset_evaluate`, `intt` and
   `coset_interpolate`, one and two four-step levels.
4. `sub_ntt_plain`'s options equal their definition written out.
Field words: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boundless_tpu.core import ntt as JNTT
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.kernels import ntt as NK

P = F.P


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def canon(x):
    """Montgomery words -> canonical int64 numpy (products stay exact)."""
    return np.asarray(x, dtype=np.int64) * F.R_INV % P


def run_schedule(x, log_m, forward):
    """csrc/ntt.cu's passes on an (m, lanes) tile of canonical ints: pass
    (lrp, lns) reads rows j + r*m/RP, multiplies element r by
    w_m^(r * (j mod Ns) * m / (Ns RP)), runs the natural-order radix-2 DFT
    of size RP with w_(2s)^jx = w_m^(jx * m / 2s) and writes rows
    (j / Ns) Ns RP + j mod Ns + r Ns."""
    m = 1 << log_m
    tw = canon(NK.pow_table(m, forward))
    v = x.copy()
    for lrp, lns in NK.radix_passes(log_m):
        rp, ns = 1 << lrp, 1 << lns
        out = np.empty_like(v)
        for jj in range(m // rp):
            a = [v[jj + r * (m // rp)] for r in range(rp)]
            e = (jj & (ns - 1)) << (log_m - lns - lrp)
            a = [a[r] * tw[r * e] % P for r in range(rp)]
            for st in range(lrp):
                s = 1 << st
                u = [None] * rp
                for b in range(rp // 2):
                    jx = b & (s - 1)
                    o = ((b - jx) << 1) + jx
                    wb = a[b + rp // 2] * tw[jx << (log_m - st - 1)] % P
                    u[o] = (a[b] + wb) % P
                    u[o + s] = (a[b] - wb) % P
                a = u
            d = ((jj >> lns) << (lns + lrp)) + (jj & (ns - 1))
            for r in range(rp):
                out[d + r * ns] = a[r]
        v = out
    return v


@pytest.mark.parametrize("forward", [True, False])
def test_kernel_schedule_equals_stockham(forward):
    for log_m in range(NK.MAX_LOG_M + 1):
        m = 1 << log_m
        x = words((m, 3), log_m)
        got = run_schedule(canon(x), log_m, forward)
        want = NTT.stockham(t(x), forward).numpy()
        np.testing.assert_array_equal(got, canon(want))
        passes = NK.radix_passes(log_m)
        assert sum(lrp for lrp, _ in passes) == log_m
        assert len(passes) == -(-log_m // NK.LOG_R)
    # M = 1024 at R = 32: two passes, one exchange through shared memory
    assert NK.radix_passes(10) == [(5, 0), (5, 5)]


@pytest.mark.parametrize("m", [2, 64, 512, NK.MAX_M])
def test_pow_table_holds_the_stage_twiddles(m):
    for forward in (True, False):
        pows = NK.pow_table(m, forward)
        assert pows.shape == (m,)
        for st, table in enumerate(NTT._stage_twiddles(m, forward)):
            s = 1 << st
            np.testing.assert_array_equal(
                pows[np.arange(s) * (m // (2 * s))], table)


def jax_words(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def assert_same(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


G_INV = pow(F.GENERATOR, P - 2, P)


@pytest.mark.parametrize("n,shape,expand", [
    (256, (5,), 4),  # one launch
    (1 << 11, (2, 2), 2),  # one four-step level, trailing axes
    (1 << 11, (4,), 4),  # the quotient's ext columns
    (1 << 13, (3,), 4),
])
def test_fused_glue_equals_jax(n, shape, expand):
    c = words((n,) + shape, n + expand)
    big = n * expand
    ev = NTT._fused(t(c), big, True, shift=F.GENERATOR)
    assert_same(ev, JNTT.coset_evaluate(jax_words(c), expand))
    assert torch.equal(ev, NTT.coset_evaluate(t(c), expand))  # CPU route
    back = NTT._fused(ev, big, False, rows_out=n,
                      store=(G_INV, pow(big, P - 2, P)))
    assert_same(back, JNTT.coset_interpolate(jax_words(ev.numpy()), expand))
    assert torch.equal(back, t(c))
    inv = NTT._fused(ev, big, False, store=(1, pow(big, P - 2, P)))
    assert_same(inv, JNTT.intt(jax_words(ev.numpy())))


def test_fused_glue_past_one_level():
    """N = 2^21 > MAX_M^2: the store tables reach the last launch of the
    inner four-step."""
    n, big = 1 << 19, 1 << 21
    assert NTT._split(big)[1] > NK.MAX_M
    c = t(words((n, 1), 3))
    ev = NTT._fused(c, big, True, shift=F.GENERATOR)
    assert torch.equal(ev, NTT.coset_evaluate(c, 4))
    back = NTT._fused(ev, big, False, rows_out=n,
                      store=(G_INV, pow(big, P - 2, P)))
    assert torch.equal(back, c)


@pytest.mark.parametrize("m,rows_in,lanes,inner", [
    (1, 1, 3, 3), (2, 1, 4, 2), (64, 16, 12, 4), (NK.MAX_M, 256, 6, 3)])
def test_plain_options_equal_their_definition(m, rows_in, lanes, inner):
    x = t(words((rows_in, lanes), m))
    q = lanes // inner
    la, lb = t(words((m,), 1)), t(words((q,), 2))
    sa, sb = t(words((m,), 3)), t(words((q,), 4))
    got = NK.sub_ntt(x, True, m=m, inner=inner, load=(la, lb),
                     store=(sa, sb), rows_out=m // 2 or 1)
    col = torch.arange(lanes) // inner
    pad = torch.zeros((m, lanes), dtype=torch.int32)
    pad[:rows_in] = F.mul(x, F.mul(la[:rows_in, None], lb[col][None]))
    want = F.mul(NTT.stockham(pad, True), F.mul(sa[:, None], sb[col][None]))
    assert torch.equal(got, want[: m // 2 or 1])
    # A alone (B None): a per-row factor
    got = NK.sub_ntt(x, False, m=m, store=(sa, None))
    assert torch.equal(got, F.mul(NTT.stockham(
        torch.cat([x, torch.zeros((m - rows_in, lanes), dtype=torch.int32)]),
        False), sa[:, None]))
