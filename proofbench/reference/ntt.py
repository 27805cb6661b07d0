"""Number-theoretic transform and low-degree extension over Baby Bear.

Frozen copy of `boundless_tpu_torch/core/ntt.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F

INV_RATE = 4  # blowup factor of the constraint-evaluation grid


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n: int, forward: bool):
    """Per-stage twiddle tables (Montgomery int32 numpy) for size-n NTT."""
    logn = n.bit_length() - 1
    assert 1 << logn == n and logn <= F.TWO_ADICITY
    roots = F.ROU_FWD if forward else F.ROU_REV
    tables = []
    for t in range(logn):
        m = 1 << t
        tables.append(F.mont_np(_powers(roots[t + 1], m)).astype(np.int32))
    return tables


def _powers(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^{n-1}] mod P, int64 numpy, by log-doubling."""
    out = np.ones(1, dtype=np.int64)
    cur = base % F.P
    while len(out) < n:
        out = np.concatenate([out, out * cur % F.P])
        cur = cur * cur % F.P
    return out[:n]


@functools.lru_cache(maxsize=None)
def _device_twiddles(n: int, forward: bool, device):
    return [torch.from_numpy(t).to(device)
            for t in _stage_twiddles(n, forward)]


def ntt(x, forward: bool = True):
    """In-order NTT along axis 0 (plain Stockham)."""
    return stockham(x, forward)


def stockham(x, forward: bool = True):
    """Plain radix-2 Stockham NTT along axis 0 (log2 N torch stages)."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    assert 1 << logn == n, f"NTT size must be a power of two, got {n}"
    batch = x.shape[1:]
    tws = _device_twiddles(n, forward, x.device)
    # View as (L, m, batch...): L sub-transforms of length m.
    y = x.reshape((n, 1) + batch)
    for t in range(logn):
        half = y.shape[0] // 2
        a, b = y[:half], y[half:]
        wb = F.mul(b, tws[t].reshape((1, -1) + (1,) * len(batch)))
        y = torch.cat([F.add(a, wb), F.sub(a, wb)], dim=1)
    return y.reshape((n,) + batch)


def intt(x):
    """Inverse NTT along axis 0 (includes the 1/N scale)."""
    return intt_plain(x)


def intt_plain(x):
    """Plain torch `intt` on any device: Stockham, then an eager 1/N."""
    n = x.shape[0]
    return F.mul(stockham(x, forward=False),
                 F.const(pow(n, F.P - 2, F.P), x.device))


@functools.lru_cache(maxsize=None)
def _coset_powers(n: int, inverse: bool, device):
    """g^i (or g^-i) for i < n, Montgomery int32 tensor."""
    g = F.GENERATOR if not inverse else pow(F.GENERATOR, F.P - 2, F.P)
    return torch.from_numpy(
        F.mont_np(_powers(g, n)).astype(np.int32)).to(device)


def coset_evaluate(coeffs, expand: int = INV_RATE):
    """Evaluate coefficients (N, ...) on the coset g * H_{expand*N}."""
    return coset_evaluate_plain(coeffs, expand)


def coset_evaluate_plain(coeffs, expand: int = INV_RATE):
    """Plain torch `coset_evaluate` on any device: an eager shift into a
    zero-padded buffer, then Stockham."""
    n = coeffs.shape[0]
    shift = _coset_powers(n, False, coeffs.device).reshape(
        (n,) + (1,) * (coeffs.dim() - 1))
    padded = torch.zeros((n * expand,) + coeffs.shape[1:], dtype=F.I32,
                         device=coeffs.device)
    padded[:n] = F.mul(coeffs, shift)
    return stockham(padded)


def coset_interpolate(evals, expand: int = INV_RATE):
    """Inverse of coset_evaluate: recover the low N coefficients."""
    return coset_interpolate_plain(evals, expand)


def coset_interpolate_plain(evals, expand: int = INV_RATE):
    """Plain torch `coset_interpolate` on any device."""
    n = evals.shape[0] // expand
    coeffs = intt_plain(evals)[:n]
    unshift = _coset_powers(n, True, evals.device).reshape(
        (n,) + (1,) * (evals.dim() - 1))
    return F.mul(coeffs, unshift)


def interpolate(evals):
    """Trace evaluations on H_N (natural order) -> coefficients."""
    return intt(evals)


def ext_powers(z, n: int):
    """Powers z^0..z^{n-1} of an ext element, shape (n, 4), log-doubling:
    each step one ext_mul of [pows; cur] by cur gives the next len(pows)
    powers and cur^2."""
    pows = F.ext_ones((1,), z.device)
    cur = z.reshape(1, F.EXT_DEGREE)
    while pows.shape[0] < n:
        both = torch.cat([pows, cur], dim=0)
        prod = F.ext_mul(both, cur.expand(both.shape))
        pows = torch.cat([pows, prod[:-1]], dim=0)
        cur = prod[-1:]
    return pows[:n]


def eval_poly_ext(coeffs, z):
    """Base-field polynomials (N, C) at an extension point z -> (C, 4).

    Σ_i c_i * z^i per component: products reduced mod P, summed in int64
    in chunks of rows, one Montgomery reduction at the end."""
    n, c = coeffs.shape
    pows = ext_powers(z, n).to(torch.int64)  # (N, 4)
    acc = torch.zeros((c, F.EXT_DEGREE), dtype=torch.int64,
                      device=coeffs.device)
    step = max(1, (1 << 24) // max(1, c * F.EXT_DEGREE))
    for r0 in range(0, n, step):
        blk = coeffs[r0:r0 + step].to(torch.int64)
        acc += ((blk[:, :, None] * pows[r0:r0 + step, None, :]) % F.P).sum(0)
        acc %= F.P
    return F._reduce(acc)


def eval_ext_poly_ext(coeffs, z):
    """Evaluate an ext-coefficient polynomial (N, 4) at ext point z -> (4,)."""
    return F.sum_mod(F.ext_mul(coeffs, ext_powers(z, coeffs.shape[0])), 0)
