"""Number-theoretic transform and low-degree extension over Baby Bear.

Counterpart of `boundless_tpu/core/ntt.py`: transforms along axis 0 of an
(N, ...) tensor, natural order in and out, batched over every trailing
axis; commitments live on the coset GENERATOR * H_{expand*N}.

`ntt` on a CUDA tensor always runs `ntt_four_step` (the reference's
`core/ntt_pallas.py` decomposition) through the hand-written sub-transform
kernel (`kernels/ntt.py`, `csrc/ntt.cu`), at every N: one launch when N
fits the kernel, two per four-step level otherwise. On a CPU tensor it is
the plain radix-2 Stockham (`stockham`). Field arithmetic is exact, so
every split and stage order gives the reference's words bit for bit.
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
    """In-order NTT along axis 0. x: int32 Montgomery, shape (N, ...).

    The CUDA kernel's four-step on a CUDA tensor, Stockham on the CPU."""
    n = x.shape[0]
    assert n and n & (n - 1) == 0, f"NTT size must be a power of two, got {n}"
    if x.device.type == "cuda":
        return ntt_four_step(x, forward)
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


def _split(n: int):
    """n = n1 * n2 with n1 <= the kernel's largest sub-transform."""
    from ..kernels import ntt as NK

    logn = n.bit_length() - 1
    log1 = min((logn + 1) // 2, NK.MAX_LOG_M)
    return 1 << log1, 1 << (logn - log1)


@functools.lru_cache(maxsize=None)
def _mid_twiddles(n1: int, n2: int, forward: bool, device):
    """w_N^(k1 * j) for k1 < n1, j < n2 (Montgomery int32, (n1, n2))."""
    n = n1 * n2
    roots = F.ROU_FWD if forward else F.ROU_REV
    pows = _powers(roots[n.bit_length() - 1], n)
    exps = np.arange(n1, dtype=np.int64)[:, None] * np.arange(n2)[None, :]
    return torch.from_numpy(
        F.mont_np(pows[exps % n]).astype(np.int32)).to(device)


def _leading_ntt(x2d, forward: bool):
    """NTT along axis 0 of a contiguous (n, L): one sub-transform when n
    fits the kernel, else one four-step level (the first sub-transform
    stores B = A * w_N^(k1*j) transposed to (n2, n1*L)) and a recursion."""
    from ..kernels import ntt as NK

    n, lanes = x2d.shape
    if n <= NK.MAX_M:
        return NK.sub_ntt(x2d, forward)
    n1, n2 = _split(n)
    bt = NK.sub_ntt(x2d.reshape(n1, n2 * lanes), forward,
                    mid=_mid_twiddles(n1, n2, forward, x2d.device))
    return _leading_ntt(bt, forward).reshape(n, lanes)


def ntt_four_step(x, forward: bool = True):
    """Four-step NTT (the reference's `ntt_pallas.ntt_four_step`):
    N = N1*N2, n = n1*N2 + j, k = k2*N1 + k1. A[k1, j] = NTT_N1 along n1,
    B = A * w_N^(k1*j), transpose to (N2, N1), NTT_N2 along j; the
    (N2, N1) result is the natural-order output. Bit-identical to
    `stockham` (exact field math)."""
    n = x.shape[0]
    lanes = x[0].numel() if n else 0
    y = _leading_ntt(x.reshape(n, lanes).contiguous(), forward)
    return y.reshape(x.shape)


def intt(x):
    """Inverse NTT along axis 0 (includes the 1/N scale)."""
    n = x.shape[0]
    n_inv = F.const(pow(n, F.P - 2, F.P), x.device)
    return F.mul(ntt(x, forward=False), n_inv)


@functools.lru_cache(maxsize=None)
def _coset_powers(n: int, inverse: bool, device):
    """g^i (or g^-i) for i < n, Montgomery int32 tensor."""
    g = F.GENERATOR if not inverse else pow(F.GENERATOR, F.P - 2, F.P)
    return torch.from_numpy(
        F.mont_np(_powers(g, n)).astype(np.int32)).to(device)


def coset_evaluate(coeffs, expand: int = INV_RATE):
    """Evaluate coefficients (N, ...) on the coset g * H_{expand*N}."""
    n = coeffs.shape[0]
    shift = _coset_powers(n, False, coeffs.device).reshape(
        (n,) + (1,) * (coeffs.dim() - 1))
    padded = torch.zeros((n * expand,) + coeffs.shape[1:], dtype=F.I32,
                         device=coeffs.device)
    padded[:n] = F.mul(coeffs, shift)
    return ntt(padded)


def coset_interpolate(evals, expand: int = INV_RATE):
    """Inverse of coset_evaluate: recover the low N coefficients."""
    n = evals.shape[0] // expand
    coeffs = intt(evals)[:n]
    unshift = _coset_powers(n, True, evals.device).reshape(
        (n,) + (1,) * (evals.dim() - 1))
    return F.mul(coeffs, unshift)


def interpolate(evals):
    """Trace evaluations on H_N (natural order) -> coefficients."""
    return intt(evals)


def ext_powers(z, n: int):
    """Powers z^0..z^{n-1} of an ext element, shape (n, 4), log-doubling."""
    pows = F.ext_ones((1,), z.device)
    cur = z.reshape(1, F.EXT_DEGREE)
    while pows.shape[0] < n:
        nxt = F.ext_mul(pows, cur.expand(pows.shape))
        pows = torch.cat([pows, nxt], dim=0)
        cur = F.ext_mul(cur, cur)
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
