"""Number-theoretic transform and low-degree extension over Baby Bear.

Counterpart of `boundless_tpu/core/ntt.py`: transforms along axis 0 of an
(N, ...) tensor, natural order in and out, batched over every trailing
axis; commitments live on the coset GENERATOR * H_{expand*N}.

`ntt` on a CUDA tensor always runs `ntt_four_step` (the reference's
`core/ntt_pallas.py` decomposition) through the hand-written sub-transform
kernel (`kernels/ntt.py`, `csrc/ntt.cu`), at every N: one launch when N
fits the kernel, two per four-step level otherwise. On a CUDA tensor the
LDE glue runs inside those launches too: `coset_evaluate` reads the N
coefficient rows and multiplies by g^i as it loads (no zero-padded buffer),
`intt` scales by 1/N and `coset_interpolate` by g^-k / N as the last launch
stores, keeping only the rows asked for. On a CPU tensor it is the plain
radix-2 Stockham (`stockham`) and eager glue. Field arithmetic is exact,
so every split and stage order gives the reference's words bit for bit.
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


@functools.lru_cache(maxsize=None)
def _geometric(m: int, q: int, base: int, scale: int, device):
    """(A, B) Montgomery int32 tables with A[r] * B[j] = scale * base^(r*q
    + j) for r < m, j < q: the kernel's multiplier of tile element (r, c),
    c // L = j, whose row of the whole transform is r*q + j. B is None
    when base is 1 (A alone)."""
    a = F.mont_np(scale * _powers(pow(base, q, F.P), m) % F.P)
    b = None if base == 1 else torch.from_numpy(
        F.mont_np(_powers(base, q)).astype(np.int32)).to(device)
    return torch.from_numpy(a.astype(np.int32)).to(device), b


def _leading_ntt(x2d, forward: bool, n=None, group=None, shift=None,
                 store=None, rows_out=None):
    """NTT along axis 0 of the (n, L') tile whose first rows are the
    contiguous `x2d` (the rest zero): one sub-transform when n fits the
    kernel, else one four-step level (the first sub-transform stores B = A
    * w_N^(k1*j) transposed to (n2, n1*L')) and a recursion.

    Options on the whole transform of the (n_total, group) array: input
    row i times shift^i (first launch), output row k times scale *
    base^k for `store` = (base, scale) (last launch), only the first
    `rows_out` output rows."""
    from ..kernels import ntt as NK

    rows, lanes = x2d.shape
    n = rows if n is None else n
    group = lanes if group is None else group
    if n <= NK.MAX_M:
        q = lanes // group
        return NK.sub_ntt(
            x2d, forward, m=n, inner=group,
            load=None if shift is None else _geometric(n, q, shift, 1,
                                                       x2d.device),
            store=None if store is None else _geometric(n, q, *store,
                                                        x2d.device),
            rows_out=rows_out)
    n1, n2 = _split(n)
    if rows % n2 or (rows_out is not None and rows_out % n1):
        raise ValueError(f"{rows} rows in / {rows_out} out do not fit the "
                         f"split {n1} x {n2}")
    load = None if shift is None else _geometric(
        n1, n2 * lanes // group, shift, 1, x2d.device)
    bt = NK.sub_ntt(x2d.reshape(rows // n2, n2 * lanes), forward,
                    mid=_mid_twiddles(n1, n2, forward, x2d.device), m=n1,
                    load=load)
    out = _leading_ntt(bt, forward, n2, group, None, store,
                       None if rows_out is None else rows_out // n1)
    return out.reshape(-1, lanes)


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


def _fused(x, n: int, forward: bool, **opts):
    """The CUDA route of the glue: the kernel's transform of the (n, ...)
    array whose first x.shape[0] rows are x, with `_leading_ntt`'s
    options; the trailing axes are flattened to lanes and restored."""
    batch = x.shape[1:]
    lanes = x[0].numel() if x.shape[0] else int(np.prod(batch, dtype=np.int64))
    x2d = x.reshape(x.shape[0], lanes).contiguous()
    y = _leading_ntt(x2d, forward, n, lanes, **opts)
    return y.reshape((y.shape[0],) + batch)


def intt(x):
    """Inverse NTT along axis 0 (includes the 1/N scale): the kernel with
    the scale in its last store on a CUDA tensor, `intt_plain` on the
    CPU."""
    n = x.shape[0]
    if x.device.type == "cuda":
        return _fused(x, n, False, store=(1, pow(n, F.P - 2, F.P)))
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
    """Evaluate coefficients (N, ...) on the coset g * H_{expand*N}: the
    kernel reading the N rows and shifting as it loads on a CUDA tensor,
    `coset_evaluate_plain` on the CPU."""
    if coeffs.device.type == "cuda":
        return _fused(coeffs, coeffs.shape[0] * expand, True,
                      shift=F.GENERATOR)
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
    """Inverse of coset_evaluate: recover the low N coefficients (the
    kernel with g^-k / N in its last store and only N rows stored on a
    CUDA tensor, `coset_interpolate_plain` on the CPU)."""
    if evals.device.type == "cuda":
        big = evals.shape[0]
        return _fused(evals, big, False, rows_out=big // expand,
                      store=(pow(F.GENERATOR, F.P - 2, F.P),
                             pow(big, F.P - 2, F.P)))
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
