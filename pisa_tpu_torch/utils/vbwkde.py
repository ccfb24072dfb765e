"""
Host copy of ``pisa_tpu/utils/vbwkde.py`` (numpy and scipy, as there).

Variable-bandwidth KDE with Improved-Sheather-Jones bandwidth selection.

Rebuild of the reference ``pisa/utils/vbwkde.py`` (``fbwkde:112``,
``vbwkde:216``, ``isj_bandwidth:382``, Botev fixed point ``:484-578``),
implemented directly from the published algorithm:

    Z. I. Botev, J. F. Grotowski, D. P. Kroese, "Kernel density estimation
    via diffusion", Annals of Statistics 38(5):2916-2957, 2010.

and the Abramson square-root law for the variable-bandwidth stage
(Abramson 1982; Hall, Hu & Marron 1995), with the reference's modification
that the bandwidth at the density maximum is pinned to the ISJ bandwidth.

These run host-side (numpy/scipy, setup-time smoothing — e.g. the legacy
vbwkde reco service); the per-event Gaussian sums use numpy broadcasting
instead of the reference's threaded numba ``gaussians`` kernel.
"""

from __future__ import annotations

import numpy as np
from scipy import fftpack, interpolate, optimize

__all__ = ["fbwkde", "vbwkde", "isj_bandwidth", "gaussians"]

_PISQ = np.pi**2
_SQRTPI = np.sqrt(np.pi)
_SQRT2PI = np.sqrt(2 * np.pi)


def gaussians(x, mu, sigma, weights=None):
    """Sum of normalized Gaussians, evaluated at `x` (cf. reference
    ``pisa/utils/gaussians.py:61``; numpy-broadcast instead of threaded
    numba). Total is normalized by the number of (effective) kernels."""
    x = np.asarray(x, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    if weights is None:
        w = np.full(mu.shape, 1.0 / mu.size)
    else:
        w = np.asarray(weights, dtype=np.float64)
        w = w / np.sum(w)
    z = (x[None, :] - mu[:, None]) / sigma[:, None]
    kern = np.exp(-0.5 * z**2) / (_SQRT2PI * sigma[:, None])
    return np.sum(w[:, None] * kern, axis=0)


def _fixed_point(t, n, i_range, a2):
    """Botev et al. fixed-point function t - xi*gamma^[l](t) (paper eq. for
    l = 7; cf. reference ``fixed_point_numba_*``)."""
    ell = 7
    f = 2.0 * np.pi ** (2 * ell) * np.sum(
        i_range**ell * a2 * np.exp(-i_range * _PISQ * t)
    )
    for s in range(ell - 1, 1, -1):
        k0 = np.prod(np.arange(1, 2 * s, 2)) / _SQRT2PI
        const = (1.0 + (0.5) ** (s + 0.5)) / 3.0
        time = (2.0 * const * k0 / (n * f)) ** (2.0 / (3.0 + 2.0 * s))
        f = 2.0 * np.pi ** (2 * s) * np.sum(
            i_range**s * a2 * np.exp(-i_range * _PISQ * time)
        )
    return t - (2.0 * n * _SQRTPI * f) ** (-0.4)


def isj_bandwidth(y, n_datapoints, x_range, min_bandwidth=0.0):
    """Improved Sheather-Jones bandwidth from a binned pmf `y`
    (cf. reference ``vbwkde.py:382``).

    Returns (bandwidth, t_star, dct_data).
    """
    y = np.asarray(y, dtype=np.float64)
    n_dct = len(y)
    dct_data = fftpack.dct(y, norm=None)
    a2 = 0.25 * (dct_data[1:] ** 2)
    i_range = np.arange(1, n_dct, dtype=np.float64) ** 2

    min_t_star = (min_bandwidth / x_range) ** 2 if min_bandwidth else 0.0
    try:
        t_star = optimize.brentq(
            _fixed_point,
            max(min_t_star / 1000, 1e-14),
            0.1,
            args=(n_datapoints, i_range, a2),
            rtol=np.finfo(np.float64).eps * 100,
        )
    except ValueError:
        # no sign change in bracket: fall back to the minimizer
        t_star = optimize.minimize_scalar(
            lambda t: abs(_fixed_point(t, n_datapoints, i_range, a2)),
            bounds=(max(min_t_star / 1000, 1e-14), 0.1),
            method="bounded",
        ).x
    t_star = max(t_star, min_t_star)
    return np.sqrt(t_star) * x_range, t_star, dct_data


def fbwkde(data, weights=None, n_dct=None, min=None, max=None,
           evaluate_dens=True, evaluate_at=None):
    """Fixed-bandwidth Gaussian KDE with the ISJ bandwidth
    (cf. reference ``vbwkde.py:112``).

    Returns (bandwidth, evaluate_at, density).
    """
    data = np.asarray(data, dtype=np.float64)
    if n_dct is None:
        n_dct = int(2 ** np.ceil(np.log2(len(data) * 10)))
    n_dct = int(n_dct)
    n = len(data)

    if min is None or max is None:
        lo, hi = data.min(), data.max()
        rng = hi - lo
        min = lo - rng / 2 if min is None else min
        max = hi + rng / 2 if max is None else max
    x_range = max - min

    hist, bins = np.histogram(
        data, bins=n_dct, range=(min, max), weights=weights
    )
    hist = hist / (n if weights is None else np.sum(weights))

    min_bandwidth = 2 * np.pi * np.mean(np.diff(np.sort(data)))
    bw, t_star, dct_data = isj_bandwidth(
        hist, n, x_range, min_bandwidth=min_bandwidth
    )

    if not evaluate_dens:
        return bw, evaluate_at, None

    if evaluate_at is None:
        # smooth in DCT space and invert
        sm = dct_data * np.exp(-np.arange(n_dct) ** 2 * _PISQ * t_star / 2)
        density = fftpack.idct(sm, norm=None) * n_dct / x_range
        evaluate_at = (bins[:-1] + bins[1:]) / 2
        if not np.any(density < 0):
            density = density / np.trapezoid(density, evaluate_at)
            return bw, evaluate_at, density
        # numerical instability: fall through to the direct sum

    evaluate_at = np.asarray(evaluate_at, dtype=np.float64)
    density = gaussians(
        evaluate_at, data, np.full(n, bw), weights=weights
    )
    return bw, evaluate_at, density


def vbwkde(data, weights=None, n_dct=None, min=None, max=None,
           n_addl_iter=0, evaluate_dens=True, evaluate_at=None):
    """Variable-bandwidth Gaussian KDE: ISJ pilot + Abramson square-root
    bandwidths, with the max-density bandwidth pinned to the ISJ value
    (cf. reference ``vbwkde.py:216-380``).

    Returns (kernel_bandwidths, evaluate_at, density).
    """
    data = np.asarray(data, dtype=np.float64)
    if n_dct is None:
        n_dct = int(2 ** np.ceil(np.log2(len(data) * 10)))

    if min is None or max is None:
        lo, hi = data.min(), data.max()
        rng = hi - lo
        min = lo - rng / 2 if min is None else min
        max = hi + rng / 2 if max is None else max

    isj_bw, grid, pilot = fbwkde(
        data, weights=weights, n_dct=n_dct, min=min, max=max
    )
    if np.any(pilot < 0):
        raise ValueError("ISJ pilot density is negative")

    # extend density profile flat out to the range edges
    xs, ys = [grid], [pilot]
    if grid[0] != min:
        xs.insert(0, [min])
        ys.insert(0, [pilot[0]])
    if grid[-1] != max:
        xs.append([max])
        ys.append([pilot[-1]])
    grid = np.concatenate(xs)
    pilot = np.concatenate(ys)

    interp = interpolate.interp1d(grid, pilot, kind="linear", copy=False)
    pilot_at_data = np.clip(interp(data), 1e-300, None)

    kernel_bandwidths = None
    density = None
    for it in range(1 + int(n_addl_iter)):
        kernel_bandwidths = (
            isj_bw
            * np.sqrt(np.max(pilot_at_data))
            / np.sqrt(pilot_at_data)
        )
        if it < n_addl_iter:
            pilot_at_data = np.clip(
                gaussians(data, data, kernel_bandwidths, weights=weights),
                1e-300,
                None,
            )
        else:
            if evaluate_at is None:
                evaluate_at = grid
            if evaluate_dens:
                density = gaussians(
                    np.asarray(evaluate_at, dtype=np.float64),
                    data,
                    kernel_bandwidths,
                    weights=weights,
                )
    return kernel_bandwidths, evaluate_at, density
