"""
Counterpart of ``pisa_tpu/utils/hypersurface_plotting.py`` on the port's
:class:`pisa_tpu_torch.utils.hypersurface.Hypersurface`.

Hypersurface fit-quality plotting (cf. reference
``pisa/utils/hypersurface/hypersurface_plotting.py:25,166``): per-bin 1-D
curves of the fitted surface vs one systematic parameter with the fitted
dataset points overlaid, a +-1 sigma band from the fit covariance, and 2-D
surface maps w.r.t. two parameters.

The Hypersurface stores all bins stacked, so these functions index one
flat bin (``bin_idx`` may be an int or a multi-dim tuple resolved through
the binning shape). The surface and its Jacobian in the coefficients come
from the module's own forms (``_surface_and_jacobian``), evaluated in
float64 on the CPU.

matplotlib is imported lazily (optional dependency).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.utils.hypersurface import _surface_and_jacobian

__all__ = ["plot_bin_fits", "plot_bin_fits_2d"]


def _flat_bin(hypersurface, bin_idx):
    if isinstance(bin_idx, (tuple, list)):
        return int(
            np.ravel_multi_index(tuple(bin_idx), hypersurface.binning.shape)
        )
    return int(bin_idx)


def _row_surface(hs, theta_row, shifted, jacobian=False):
    """The surface of one bin's packed coefficients `theta_row` (ncoeff,)
    at `shifted` ({name: array}, all of one shape), and with `jacobian`
    its partials in the coefficients (shape + (ncoeff,)), as numpy."""
    theta = torch.as_tensor(theta_row, dtype=torch.float64)
    ps = [torch.as_tensor(shifted[name], dtype=torch.float64)
          for name in hs.param_names]
    total, jac = _surface_and_jacobian(hs.forms, theta, ps, jacobian)
    return total.numpy(), None if jac is None else jac.numpy()


def _eval_curve(hypersurface, bin_idx, param_name, x, return_band=False):
    """Surface (and optional +-1 sigma band) vs `param_name` at `x`, all
    other params at nominal, for one flat bin."""
    hs = hypersurface
    theta = hs._packed_theta()[bin_idx]  # (ncoeff,)
    shifted = {
        name: (
            (x - hs.nominal_values[name])
            if name == param_name
            else np.zeros_like(x)
        )
        for name in hs.param_names
    }
    # 1-sigma band via the fit covariance: sigma^2 = J C J^T with the
    # Jacobian of the surface w.r.t. the packed coefficients
    band = return_band and hs.fit_cov_mat is not None
    y, J = _row_surface(hs, theta, shifted, jacobian=band)
    if hs.log:
        y = np.exp(y)
    if not return_band:
        return y
    if not band:
        return y, np.zeros_like(y)
    C = np.asarray(hs.fit_cov_mat[bin_idx])
    var = np.einsum("xi,ij,xj->x", J, C, J)
    sigma = np.sqrt(np.clip(var, 0.0, None))
    if hs.log:
        sigma = y * sigma  # d exp(s) = exp(s) ds
    return y, sigma


def plot_bin_fits(
    ax,
    hypersurface,
    bin_idx,
    param_name,
    color=None,
    label=None,
    hs_label=None,
    show_nominal=False,
    show_uncertainty=True,
    show_zero=False,
    xlim=None,
):
    """1-D fit-quality plot for one bin w.r.t. one parameter: fitted-dataset
    points (on-axis in this parameter), the fitted curve, an optional
    +-1 sigma band and the nominal-value line
    (cf. reference ``hypersurface_plotting.py:25``)."""
    hs = hypersurface
    b = _flat_bin(hs, bin_idx)
    if param_name not in hs.param_names:
        raise ValueError(
            f"unknown param {param_name!r}; have {hs.param_names}"
        )

    nominal = hs.nominal_values[param_name]

    # on-axis datasets: every other parameter at its nominal value
    if getattr(hs, "fit_param_values", None):
        xs, ys, es = [], [], []
        for d, pv in enumerate(hs.fit_param_values):
            on_axis = all(
                np.isclose(pv[p], hs.nominal_values[p])
                for p in hs.param_names
                if p != param_name
            )
            if not on_axis:
                continue
            xs.append(pv[param_name])
            yv = hs.fit_maps_norm[d, b]
            ys.append(np.exp(yv) if hs.log else yv)
            es.append(hs.fit_sigma[d, b])
        if xs:
            ax.errorbar(
                xs, ys, yerr=es, marker="o", linestyle="None",
                color=color, label=label,
            )

    if xlim is None:
        if getattr(hs, "fit_param_values", None):
            vals = [pv[param_name] for pv in hs.fit_param_values]
            lo, hi = min(vals), max(vals)
            pad = 0.1 * (hi - lo if hi > lo else 1.0)
            xlim = (lo - pad, hi + pad)
        else:
            xlim = (nominal - 1.0, nominal + 1.0)
    x = np.linspace(xlim[0], xlim[1], 100)

    y, sigma = _eval_curve(hs, b, param_name, x, return_band=True)
    ax.plot(x, y, color=color or "tab:red", label=hs_label)
    if show_uncertainty:
        ax.fill_between(
            x, y - sigma, y + sigma, color=color or "tab:red", alpha=0.2
        )
    if show_nominal:
        ax.axvline(
            nominal, color="blue", alpha=0.7, linestyle="-.",
            label="nominal",
        )
    if show_zero:
        ax.axhline(0.0, color="gray", lw=0.5)
    ax.set_xlabel(param_name)
    ax.set_ylabel("bin scale")
    return ax


def plot_bin_fits_2d(ax, hypersurface, bin_idx, param_names):
    """2-D surface map for one bin w.r.t. two parameters (others at
    nominal), with fitted-dataset points overlaid
    (cf. reference ``hypersurface_plotting.py:166``)."""
    hs = hypersurface
    b = _flat_bin(hs, bin_idx)
    if len(param_names) != 2:
        raise ValueError("need exactly two parameter names")
    p0, p1 = param_names

    def _range(p):
        if getattr(hs, "fit_param_values", None):
            vals = [pv[p] for pv in hs.fit_param_values]
            lo, hi = min(vals), max(vals)
            pad = 0.1 * (hi - lo if hi > lo else 1.0)
            return lo - pad, hi + pad
        n = hs.nominal_values[p]
        return n - 1.0, n + 1.0

    x = np.linspace(*_range(p0), 60)
    y = np.linspace(*_range(p1), 60)
    xx, yy = np.meshgrid(x, y, indexing="ij")

    theta = hs._packed_theta()[b]
    shifted = {
        name: (
            xx - hs.nominal_values[p0]
            if name == p0
            else (
                yy - hs.nominal_values[p1]
                if name == p1
                else np.zeros_like(xx)
            )
        )
        for name in hs.param_names
    }
    z, _ = _row_surface(hs, theta, shifted)
    if hs.log:
        z = np.exp(z)
    pc = ax.pcolormesh(x, y, z.T, shading="auto")
    import matplotlib.pyplot as plt

    plt.colorbar(pc, ax=ax, label="bin scale")

    if getattr(hs, "fit_param_values", None):
        ax.scatter(
            [pv[p0] for pv in hs.fit_param_values],
            [pv[p1] for pv in hs.fit_param_values],
            color="k", marker="x", s=30,
        )
    ax.set_xlabel(p0)
    ax.set_ylabel(p1)
    return ax
