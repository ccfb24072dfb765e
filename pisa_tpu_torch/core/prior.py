"""
Host copy of ``pisa_tpu/core/prior.py`` with its imports rewritten to
``pisa_tpu_torch``.

Priors on parameters (cf. reference ``pisa/core/prior.py:55``).

Kinds: uniform, gaussian, linterp, spline, jeffreys. ``llh(x)`` returns the
log-prior (up to a constant), ``chi2(x) = -2*llh(x)``. Values may be passed as
Quantities or bare numbers (interpreted in the prior's units).

:meth:`Prior.llh_torch` is the counterpart of the JAX package's
``llh_jax``: the penalty as a differentiable torch function of the parameter
magnitude in the prior's units (the compiled template's objective).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import splev

from pisa_tpu_torch.units import Quantity
from pisa_tpu_torch.utils.comparisons import interpret_quantity, recursiveEquality

__all__ = ["Prior"]


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of the tensors (xp, fp) (xp
    increasing, on `x`'s device) at the tensor `x`, differentiable in `x`,
    constant beyond the ends (the semantics of ``np.interp``; torch has no
    ``interp``)."""
    flat = x.reshape(-1)
    i = torch.searchsorted(xp, flat.detach(), right=True).clamp(1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    inside = f0 + (flat - x0) * (f1 - f0) / (x1 - x0)
    out = torch.where(flat < xp[0], fp[0],
                      torch.where(flat > xp[-1], fp[-1], inside))
    return out.reshape(x.shape)


class Prior:
    """A prior over a single parameter.

    Examples
    --------
    >>> Prior(kind='uniform')
    >>> Prior(kind='gaussian', mean=0.5 * ureg.deg, stddev=0.1 * ureg.deg)
    >>> Prior(kind='linterp', param_vals=[0, 1], llh_vals=[0, -1])
    >>> Prior(kind='spline', knots=..., coeffs=..., deg=3)
    >>> Prior(kind='jeffreys', A=1e-4, B=1.0)
    """

    def __init__(self, kind, **kwargs):
        kind = kind.lower() if isinstance(kind, str) else kind
        if kind in (None, "none", "uniform"):
            self.kind = "uniform"
            self.llh_offset = kwargs.pop("llh_offset", 0.0)
            self.units = None
            self.max_at = np.nan
        elif kind == "gaussian":
            self.kind = "gaussian"
            mean = interpret_quantity(kwargs.pop("mean"))
            stddev = interpret_quantity(kwargs.pop("stddev"))
            self.units = str(mean.units)
            self.mean = mean
            self.stddev = stddev.to(mean.units)
            self.max_at = self.mean
        elif kind == "linterp":
            self.kind = "linterp"
            pv = interpret_quantity(
                kwargs.pop("param_vals"), expect_sequence=True
            )
            lv = np.asarray(kwargs.pop("llh_vals"), dtype=float)
            order = np.argsort(np.asarray(pv.magnitude))
            self.param_vals = Quantity(
                np.asarray(pv.magnitude, dtype=float)[order], pv.units
            )
            self.llh_vals = lv[order]
            self.units = str(pv.units)
            imax = int(np.argmax(self.llh_vals))
            self.max_at = Quantity(self.param_vals.magnitude[imax], pv.units)
        elif kind == "spline":
            self.kind = "spline"
            knots = kwargs.pop("knots")
            # reference prior files carry bare knots + a separate 'units'
            # entry (e.g. priors/nufitv20standardtheta23splines.json)
            units = kwargs.pop("units", None)
            if units is not None and not isinstance(knots, Quantity):
                knots = Quantity(np.asarray(knots, dtype=float), units)
            self.knots = interpret_quantity(knots, expect_sequence=True)
            self.coeffs = np.asarray(kwargs.pop("coeffs"), dtype=float)
            self.deg = int(kwargs.pop("deg"))
            self.units = str(self.knots.units)
            # locate maximum numerically over the knot range
            k = np.asarray(self.knots.magnitude, dtype=float)
            xs = np.linspace(k[0], k[-1], 1000)
            ys = splev(xs, (k, self.coeffs, self.deg))
            self.max_at = Quantity(xs[int(np.argmax(ys))], self.knots.units)
        elif kind == "jeffreys":
            self.kind = "jeffreys"
            A = interpret_quantity(kwargs.pop("A"))
            B = interpret_quantity(kwargs.pop("B"))
            self.units = str(A.units)
            self.A = A
            self.B = B.to(A.units)
            self.max_at = self.A
        else:
            raise TypeError(f"Unknown Prior kind {kind!r}")
        if kwargs:
            raise TypeError(
                f"Unused kwargs for Prior(kind={self.kind!r}): {list(kwargs)}"
            )
        self._torch_tables = {}  # device -> llh_torch's interpolation table

    # -- evaluation ---------------------------------------------------------
    def _strip(self, x):
        if isinstance(x, Quantity):
            if self.units is not None:
                return np.asarray(x.m_as(self.units), dtype=float)
            # unitless prior (e.g. uniform): use the bare magnitude
            return np.asarray(x.magnitude, dtype=float)
        return np.asarray(x, dtype=float)

    def llh(self, x):
        x = self._strip(x)
        if self.kind == "uniform":
            return 0.0 * x + self.llh_offset
        if self.kind == "gaussian":
            m = float(self.mean.magnitude)
            s = float(self.stddev.magnitude)
            return -((x - m) ** 2) / (2 * s**2)
        if self.kind == "linterp":
            pv = np.asarray(self.param_vals.magnitude, dtype=float)
            if np.any(x < pv[0]) or np.any(x > pv[-1]):
                raise ValueError(
                    f"Value {x} out of linterp prior range [{pv[0]}, {pv[-1]}]"
                )
            return np.interp(x, pv, self.llh_vals)
        if self.kind == "spline":
            k = np.asarray(self.knots.magnitude, dtype=float)
            return splev(x, (k, self.coeffs, self.deg))
        if self.kind == "jeffreys":
            A = float(self.A.magnitude)
            B = float(self.B.magnitude)
            return -np.log(x) + np.log(np.log(B) - np.log(A))
        raise AssertionError(self.kind)

    def chi2(self, x):
        return -2.0 * self.llh(x)

    def _interp_table(self, device):
        """The (x, llh) table of a linterp or spline prior (the spline
        sampled on 2048 points) as float64 tensors on `device`, built and
        uploaded once per device."""
        tables = self._torch_tables
        if device not in tables:
            if self.kind == "linterp":
                xs = np.asarray(self.param_vals.magnitude, dtype=float)
                ys = np.asarray(self.llh_vals, dtype=float)
            else:
                k = np.asarray(self.knots.magnitude, dtype=float)
                xs = np.linspace(k[0], k[-1], 2048)
                ys = np.asarray(splev(xs, (k, self.coeffs, self.deg)),
                                dtype=float)
            tables[device] = tuple(
                torch.as_tensor(a, dtype=torch.float64, device=device)
                for a in (xs, ys)
            )
        return tables[device]

    def llh_torch(self, x_mag):
        """llh of a magnitude in this prior's units (a tensor on any device,
        or a number), differentiable in it and computed where it lies,
        without reading it back (``pisa_tpu/core/prior.py:134-158``);
        linterp and spline priors interpolate linearly (the spline sampled
        on 2048 points once), holding the end values outside the knots as
        ``jnp.interp`` does."""
        x = torch.as_tensor(x_mag, dtype=torch.float64)
        if self.kind == "uniform":
            return 0.0 * x + self.llh_offset
        if self.kind == "gaussian":
            m = float(self.mean.magnitude)
            s = float(self.stddev.magnitude)
            return -torch.square(x - m) / (2 * s**2)
        if self.kind in ("linterp", "spline"):
            return _interp(x, *self._interp_table(x.device))
        if self.kind == "jeffreys":
            A = float(self.A.magnitude)
            B = float(self.B.magnitude)
            return -torch.log(x) + np.log(np.log(B) - np.log(A))
        raise AssertionError(self.kind)

    def get_prior_bounds(self, entity="llh", metric="llh", stddev=1.0):
        """Parameter bounds enclosing `stddev` sigmas for this prior."""
        if np.isscalar(stddev):
            stddev = [stddev]
        chi2_vals = [s**2 for s in stddev]
        bounds = {}
        if self.kind == "gaussian":
            for s, c2 in zip(stddev, chi2_vals):
                m, sd = self.mean, self.stddev
                bounds[s] = (m - sd * np.sqrt(c2), m + sd * np.sqrt(c2))
            return bounds
        if self.kind in ("linterp", "spline"):
            if self.kind == "linterp":
                xs = np.asarray(self.param_vals.magnitude, dtype=float)
                ys = np.asarray(self.llh_vals, dtype=float)
                units = self.param_vals.units
            else:
                k = np.asarray(self.knots.magnitude, dtype=float)
                xs = np.linspace(k[0], k[-1], 10000)
                ys = np.asarray(splev(xs, (k, self.coeffs, self.deg)))
                units = self.knots.units
            chi2_arr = -2 * (ys - ys.max())
            for s, c2 in zip(stddev, chi2_vals):
                inside = xs[chi2_arr <= c2]
                bounds[s] = (
                    Quantity(inside.min(), units),
                    Quantity(inside.max(), units),
                )
            return bounds
        raise NotImplementedError(
            f"get_prior_bounds not defined for kind {self.kind!r}"
        )

    # -- identity / serialization ------------------------------------------
    @property
    def state(self):
        s = dict(kind=self.kind)
        if self.kind == "uniform":
            s["llh_offset"] = self.llh_offset
        elif self.kind == "gaussian":
            s["mean"] = self.mean
            s["stddev"] = self.stddev
        elif self.kind == "linterp":
            s["param_vals"] = self.param_vals
            s["llh_vals"] = self.llh_vals
        elif self.kind == "spline":
            s["knots"] = self.knots
            s["coeffs"] = self.coeffs
            s["deg"] = self.deg
        elif self.kind == "jeffreys":
            s["A"] = self.A
            s["B"] = self.B
        return s

    @property
    def serializable_state(self):
        return self.state

    @classmethod
    def from_state(cls, state):
        return cls(**state)

    def __eq__(self, other):
        if not isinstance(other, Prior):
            return False
        return recursiveEquality(self.state, other.state)

    def __ne__(self, other):
        return not self == other

    def __str__(self):
        if self.kind == "gaussian":
            return f"gaussian prior: mean={self.mean}, stddev={self.stddev}"
        if self.kind == "uniform":
            return f"uniform prior, llh_offset={self.llh_offset}"
        return f"{self.kind} prior"

    __repr__ = __str__
