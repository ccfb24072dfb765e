"""
Hypersurfaces: per-bin parameterization of discrete detector systematics
(counterpart of ``pisa_tpu/utils/hypersurface.py``; reference
``pisa/utils/hypersurface/hypersurface.py:81-206`` functional forms,
``:208`` Hypersurface, ``:356`` evaluate, ``:477`` fit, ``:1598``
fit_hypersurfaces, ``:2065`` data-release CSV loading, and
``hyper_interpolator.py`` for the interpolated fits and their job workflow).

- A hypersurface over B bins is stored as stacked arrays: an intercept
  ``(B,)`` and one ``(B, nargs)`` coefficient block per systematic.
- ``evaluate`` is torch and differentiable in the parameter values; the
  ``discr_sys.hypersurfaces`` stage evaluates it inside compiled templates,
  and :func:`evaluate_stacked` evaluates a category-stacked container's
  groups in one pass. A surface's coefficients are uploaded to a device
  once; a CUDA evaluation reads nothing on the host.
- ``fit`` runs all bins at once: a batched Gauss-Newton of a fixed number of
  steps with damping, whose Jacobian is each functional form's closed-form
  derivative; the covariance is the inverse of the damped normal matrix at
  the optimum. The linear algebra uses ``solve_ex``/``inv_ex``, whose
  status the fitter keeps on the device: the loop waits for the host never,
  and a bin whose normal matrix was singular comes out NaN (as a singular
  solve does in the JAX package). The host preparation is numpy, as in the
  JAX package.
- JSON (with covariance; ``.bz2`` compressed where the name says so), the
  official data-release CSV hyperplanes, interpolation of fits over a grid
  of (oscillation) parameters, and the per-grid-point job workflow.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE
from pisa_tpu_torch.core.container import resolve_device
from pisa_tpu_torch.core.stage import in_data_type
from pisa_tpu_torch.utils.fileio import read_csv
from pisa_tpu_torch.utils.jsons import from_json, to_json
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = [
    "HYPERSURFACE_FUNCS",
    "Hypersurface",
    "HypersurfaceInterpolator",
    "evaluate_stacked",
    "fit_hypersurfaces_from_maps",
    "load_hypersurfaces",
    "save_hypersurfaces",
    "load_interpolated_hypersurfaces",
    "save_interpolated_hypersurfaces",
    "prepare_interpolated_fit",
    "run_interpolated_fit",
    "get_incomplete_job_idx",
    "assemble_interpolated_fits",
]


# -- functional forms (reference hypersurface.py:81-206) ----------------------
# each: f(p, c[..., nargs]) -> contribution, and its partials in c, one
# tensor per coefficient; p broadcasts against c[..., 0]

def _linear(p, c):
    return c[..., 0] * p


def _d_linear(p, c):
    return [p * torch.ones_like(c[..., 0])]


def _quadratic(p, c):
    return c[..., 0] * p + c[..., 1] * p**2


def _d_quadratic(p, c):
    one = torch.ones_like(c[..., 0])
    return [p * one, p**2 * one]


def _exponential(p, c):
    return torch.exp(c[..., 0] * p) - 1.0


def _d_exponential(p, c):
    return [torch.exp(c[..., 0] * p) * p]


def _exponential_scaled(p, c):
    return (c[..., 0] + 1.0) * (torch.exp(c[..., 1] * p) - 1.0)


def _d_exponential_scaled(p, c):
    e = torch.exp(c[..., 1] * p)
    return [e - 1.0, (c[..., 0] + 1.0) * (e * p)]


def _logarithmic(p, c):
    return torch.log1p(c[..., 0] * p)


def _d_logarithmic(p, c):
    return [p / (1.0 + c[..., 0] * p)]


#: name -> (form, number of coefficients, partials in the coefficients)
HYPERSURFACE_FUNCS = OrderedDict(
    [
        ("linear", (_linear, 1, _d_linear)),
        ("quadratic", (_quadratic, 2, _d_quadratic)),
        ("exponential", (_exponential, 1, _d_exponential)),
        ("exponential_scaled", (_exponential_scaled, 2, _d_exponential_scaled)),
        ("logarithmic", (_logarithmic, 1, _d_logarithmic)),
    ]
)


def _surface_and_jacobian(forms, theta, shifted, jacobian=True):
    """The surface and (with `jacobian`, else None) its partials in the
    packed coefficients `theta` (..., ncoeff), the forms' parameters at
    `shifted` (one tensor each, broadcasting against theta[..., 0]); the
    sum in the JAX package's order (intercept, then each param's term)."""
    total = theta[..., 0]
    partials = [torch.ones_like(total)]
    ofs = 1
    for name, s in zip(forms, shifted):
        fn, size, dfn = HYPERSURFACE_FUNCS[name]
        blk = theta[..., ofs:ofs + size]
        total = total + fn(s, blk)
        if jacobian:
            partials.extend(dfn(s, blk))
        ofs += size
    if not jacobian:
        return total, None
    shape = total.shape
    return total, torch.stack([d.expand(shape) for d in partials], dim=-1)


#: (func_names, ncoeff, gn_iterations, damping) -> the all-bins
#: Gauss-Newton fitter; see Hypersurface.fit
_BIN_FITTER_CACHE = {}


def _get_bin_fitter(func_names, ncoeff, gn_iterations, damping):
    """Build (or fetch) the all-bins Gauss-Newton fitter for one fit
    structure (``pisa_tpu/utils/hypersurface.py:89``). `func_names` is an
    ordered tuple of (param name, form name). The fitter takes tensors on
    one device: y and w (D, B), theta0 (ncoeff,), the shifted values (one
    (D,) tensor per param); it returns theta (B, ncoeff) and cov (B,
    ncoeff, ncoeff) on that device, and reads nothing on the host."""
    key = (func_names, ncoeff, gn_iterations, damping)
    if key in _BIN_FITTER_CACHE:
        return _BIN_FITTER_CACHE[key]
    forms = [f for _n, f in func_names]

    def normal_matrix(theta, yb, wb, shifted):
        pred, jac = _surface_and_jacobian(forms, theta[:, None, :], shifted)
        jw = jac * wb[..., None]  # (B, D, ncoeff)
        eye = torch.eye(ncoeff, dtype=theta.dtype, device=theta.device)
        a = jw.mT @ jac + damping * eye
        return a, (jw.mT @ (yb - pred)[..., None])[..., 0]

    def fitter(y, w, theta0, shifted):
        yb, wb = y.T, w.T  # (B, D)
        theta = theta0.expand(yb.shape[0], ncoeff)
        singular = torch.zeros(yb.shape[0], dtype=torch.bool,
                               device=yb.device)
        for _ in range(gn_iterations):
            a, g = normal_matrix(theta, yb, wb, shifted)
            step, info = torch.linalg.solve_ex(a, g)
            singular = singular | (info != 0)
            theta = theta + step
        a, _ = normal_matrix(theta, yb, wb, shifted)
        cov, info = torch.linalg.inv_ex(a)
        singular = (singular | (info != 0))[:, None]
        theta = torch.where(singular, torch.nan, theta)
        cov = torch.where(singular[..., None], torch.nan, cov)
        return theta, cov

    _BIN_FITTER_CACHE[key] = fitter
    return fitter


def _param_tensor(value, device, lanes=None):
    """A parameter value as a tensor of the data's type on `device`: () or,
    with `lanes`, (lanes,); a host number is filled in on the device."""
    shape = () if lanes is None else (lanes,)
    if isinstance(value, torch.Tensor):
        value = value.to(TORCH_FTYPE)
        return value.reshape(-1).expand(shape) if lanes is not None else value
    return torch.full(shape, float(value), dtype=TORCH_FTYPE, device=device)


def _scale_and_sigma(total, grad, cov, finite, log, return_uncertainty):
    """The scale from the surface `total` (exp in `log` mode), NaN outside
    the `finite` rows; with `return_uncertainty` also sqrt(g . cov . g)
    from the surface's gradient `grad` in the coefficients (times the scale
    in log mode; zeros without a covariance). The rows outside `finite`
    are set to NaN last, so that no NaN enters the autograd graph."""
    scale = torch.exp(total) if log else total
    sigma = None
    if return_uncertainty and cov is not None:
        var = torch.einsum("...i,...ij,...j->...", grad, cov, grad)
        if finite is not None:
            var = torch.where(finite, var, 1.0)  # a finite sqrt' there
        sigma = torch.sqrt(torch.clamp(var, min=0.0))
        if log:
            sigma = sigma * scale
    if finite is not None:
        nan = torch.full((), torch.nan, dtype=total.dtype,
                         device=total.device)
        scale = torch.where(finite, scale, nan)
        if sigma is not None:
            sigma = torch.where(finite, sigma, nan)
    if not return_uncertainty:
        return scale
    return scale, torch.zeros_like(scale) if sigma is None else sigma


class Hypersurface:
    """Stacked per-bin hypersurfaces: ``scale_b = intercept_b +
    sum_k f_k(p_k - nominal_k; coeffts_k[b])`` (optionally in log space).

    Parameters
    ----------
    binning : MultiDimBinning
    param_names : list of str
    func_names : dict name -> functional-form name
    nominal_values : dict name -> float (NaN for legacy data-release files,
        whose evaluation uses raw param values)
    log : bool
        fit/evaluate in log space (scale = exp(surface))
    using_legacy_data : bool
        evaluate at the raw param values (the data release's hyperplanes)

    The coefficients (``intercept``, ``coeffts``, ``fit_cov_mat``) are
    uploaded to a device at the first evaluation there; assign new arrays
    to change them (an array changed in place keeps its upload).
    """

    def __init__(
        self,
        binning,
        param_names,
        func_names,
        nominal_values=None,
        log=False,
        using_legacy_data=False,
    ):
        self.binning = binning
        self.param_names = list(param_names)
        self.func_names = dict(func_names)
        self.nominal_values = dict(nominal_values or {})
        self.log = log
        self.using_legacy_data = using_legacy_data

        n = binning.size
        self.intercept = np.ones(n, dtype=FTYPE)
        self.coeffts = {
            name: np.zeros((n, HYPERSURFACE_FUNCS[self.func_names[name]][1]),
                           dtype=FTYPE)
            for name in self.param_names
        }
        self.fit_cov_mat = None  # (n, ncoeff, ncoeff) incl. intercept first
        self.fit_valid = np.ones(n, dtype=bool)
        self._device_arrays = {}

    # -- layout helpers -------------------------------------------------------
    @property
    def num_coeffts(self):
        return 1 + sum(
            HYPERSURFACE_FUNCS[self.func_names[k]][1] for k in self.param_names
        )

    @property
    def forms(self):
        return [self.func_names[k] for k in self.param_names]

    def _unpack(self, theta):
        """theta (..., ncoeff) -> (intercept, {name: (..., nargs)})."""
        intercept = theta[..., 0]
        out = {}
        i = 1
        for name in self.param_names:
            nargs = HYPERSURFACE_FUNCS[self.func_names[name]][1]
            out[name] = theta[..., i : i + nargs]
            i += nargs
        return intercept, out

    def _packed_theta(self):
        parts = [np.asarray(self.intercept)[:, None]]
        parts += [np.asarray(self.coeffts[k]) for k in self.param_names]
        return np.concatenate(parts, axis=1)  # (B, ncoeff)

    def _nominal_vector(self):
        """The nominal value of each param (0 where evaluation uses the raw
        values)."""
        if self.using_legacy_data:
            return np.zeros(len(self.param_names))
        return np.asarray([self.nominal_values[k] for k in self.param_names],
                          dtype=np.float64)

    def _finite_arrays(self):
        """(theta, cov or None, finite rows or None) on the host: the rows
        of theta that are not finite (bins whose fit was not valid) hold
        the identity surface, and their covariance zeros, so that an
        evaluation's gradient stays finite; `finite` marks the rows to keep
        (None where all are)."""
        theta = self._packed_theta()
        cov = None if self.fit_cov_mat is None else np.asarray(
            self.fit_cov_mat)
        finite = np.isfinite(theta).all(axis=-1)
        if finite.all():
            return theta, cov, None
        identity = np.zeros(theta.shape[-1])
        identity[0] = 0.0 if self.log else 1.0
        theta = np.where(finite[..., None], theta, identity)
        if cov is not None:
            cov = np.where(finite[..., None, None], cov, 0.0)
        return theta, cov, finite

    def _on_device(self, device):
        """(theta (B, ncoeff), cov or None, finite rows (B,) or None) as
        tensors on `device` (:meth:`_finite_arrays`), uploaded once per set
        of coefficient arrays."""
        device = resolve_device(device)
        ident = (id(self.intercept), id(self.fit_cov_mat),
                 tuple(id(self.coeffts[k]) for k in self.param_names))
        cached = self._device_arrays.get(device)
        if cached is None or cached[0] != ident:
            cached = (ident,) + tuple(
                None if a is None else torch.as_tensor(
                    a, dtype=torch.bool if a.dtype == bool else TORCH_FTYPE,
                    device=device)
                for a in self._finite_arrays())
            self._device_arrays[device] = cached
        return cached[1:]

    # -- evaluation -------------------------------------------------------------
    def evaluate(self, param_values, return_uncertainty=False, device="cuda",
                 lanes=None):
        """Per-bin scale factors, flat ``(binning.size,)`` on `device`
        (reference ``hypersurface.py:356``). `param_values` maps each
        systematic to a float, a 0-d tensor (differentiable) or, with
        `lanes`, a (lanes, 1) tensor; the result is then (lanes,
        binning.size). With `return_uncertainty`, also the fit's 1-sigma
        uncertainty of the scale, ``sqrt(g . cov . g)`` with g the
        surface's gradient in the coefficients (times the scale in log
        mode; zeros without a covariance). Bins whose coefficients are not
        finite give NaN (the stage maps them to 1), with a zero gradient."""
        theta, cov, finite = self._on_device(device)
        nominal = self._nominal_vector()
        shifted = []
        for i, name in enumerate(self.param_names):
            v = in_data_type(param_values[name])
            if not self.using_legacy_data:
                v = v - float(nominal[i])
            shifted.append(v)
        total, grad = _surface_and_jacobian(self.forms, theta, shifted,
                                            return_uncertainty)
        if lanes is not None and total.dim() == 1:
            total = total.expand(lanes, -1)
            if grad is not None:
                grad = grad.expand(lanes, *grad.shape)
        return _scale_and_sigma(total, grad, cov, finite, self.log,
                                return_uncertainty)

    # -- fitting -----------------------------------------------------------------
    def fit(
        self,
        nominal_map,
        nominal_param_values,
        sys_maps,
        sys_param_values,
        norm=True,
        gn_iterations=30,
        damping=1e-9,
        device="cuda",
    ):
        """Fit all bins at once (reference ``hypersurface.py:477``) on
        `device`.

        Parameters
        ----------
        nominal_map : Map (counts at nominal)
        nominal_param_values : dict name -> float
        sys_maps : list of Map (one per systematic dataset, nominal included)
        sys_param_values : list of dict (param values per dataset)
        norm : bool
            fit maps normalized to the nominal map (reference default)
        """
        prep = self._prepare_fit_arrays(
            nominal_map, nominal_param_values, sys_maps, sys_param_values,
            norm=norm,
        )
        fitter = self._fitter(gn_iterations, damping)
        theta, cov = _read_fit(fitter(*_fit_inputs(prep, device)))
        self._ingest_fit(theta, cov, prep, sys_param_values)
        return self

    def _fitter(self, gn_iterations=30, damping=1e-9):
        """The module-cached Gauss-Newton fitter for this hypersurface's
        structure (functional forms, coefficient count, iteration
        schedule); the shifted param values are its arguments."""
        return _get_bin_fitter(
            func_names=tuple(
                (name, self.func_names[name]) for name in self.param_names
            ),
            ncoeff=self.num_coeffts,
            gn_iterations=int(gn_iterations),
            damping=float(damping),
        )

    def _prepare_fit_arrays(
        self, nominal_map, nominal_param_values, sys_maps,
        sys_param_values, norm=True,
    ):
        """Host-side prep (``pisa_tpu/utils/hypersurface.py:319``):
        normalized y/sigma stacks, 1/sigma^2 weights, validity mask,
        shifted parameter values and the Gauss-Newton seed."""
        self.nominal_values = dict(nominal_param_values)
        self.using_legacy_data = False

        B = self.binning.size
        y = np.stack(
            [np.asarray(m.hist).reshape(B) for m in sys_maps]
        ).astype(np.float64)  # (D, B)
        sig = np.stack(
            [
                np.asarray(
                    m.error_hist
                    if getattr(m, "error_hist", None) is not None
                    else np.sqrt(np.clip(np.asarray(m.hist), 0, None))
                ).reshape(B)
                for m in sys_maps
            ]
        ).astype(np.float64)
        nom = np.asarray(nominal_map.hist).reshape(B).astype(np.float64)

        if norm:
            with np.errstate(divide="ignore", invalid="ignore"):
                sig = np.where(nom > 0, sig / nom, 0.0)
                y = np.where(nom > 0, y / nom, 0.0)
        valid = (nom > 0) & np.isfinite(y).all(axis=0)
        # weights: 1/sigma^2, unit weight where sigma == 0 (zero-MC-error
        # bins); float64 so the square of a tiny sigma cannot underflow
        w = np.where(sig > 0, 1.0 / np.clip(sig, 1e-150, None) ** 2, 1.0)
        w = np.where(valid[None, :], w, 0.0)

        shifted = tuple(
            np.asarray(
                [
                    pv[name] - nominal_param_values[name]
                    for pv in sys_param_values
                ],
                dtype=FTYPE,
            )
            for name in self.param_names
        )
        if self.log:
            y = np.log(np.clip(y, 1e-10, None))

        theta0 = np.zeros(self.num_coeffts, dtype=FTYPE)
        theta0[0] = 0.0 if self.log else 1.0
        return {
            "y": y.astype(FTYPE), "w": w.astype(FTYPE), "sig": sig,
            "valid": valid, "shifted": shifted, "theta0": theta0,
        }

    def _ingest_fit(self, theta, cov, prep, sys_param_values):
        """Unpack fitted (B, ncoeff) coefficients + covariances into this
        instance (NaN for empty bins; the stage maps a non-finite scale to
        1)."""
        valid = prep["valid"]
        theta = np.array(theta, dtype=np.float64)
        cov = np.array(cov, dtype=np.float64)
        theta[~valid] = np.nan
        cov[~valid] = np.nan
        self.intercept = theta[:, 0].astype(FTYPE)
        _, blocks = self._unpack(theta)
        self.coeffts = {
            k: np.asarray(v, dtype=FTYPE) for k, v in blocks.items()
        }
        self.fit_cov_mat = cov
        self.fit_valid = valid
        # the fitted datasets, for diagnostics
        self.fit_param_values = [dict(pv) for pv in sys_param_values]
        self.fit_maps_norm = np.asarray(prep["y"])  # (D, B); log if self.log
        self.fit_sigma = np.asarray(prep["sig"])  # (D, B) normalized sigmas
        return self

    # -- serialization -----------------------------------------------------------
    @property
    def state(self):
        return {
            "binning": self.binning.state,
            "param_names": self.param_names,
            "func_names": self.func_names,
            "nominal_values": self.nominal_values,
            "log": self.log,
            "using_legacy_data": self.using_legacy_data,
            "intercept": np.asarray(self.intercept),
            "coeffts": {k: np.asarray(v) for k, v in self.coeffts.items()},
            "fit_cov_mat": None
            if self.fit_cov_mat is None
            else np.asarray(self.fit_cov_mat),
            "fit_valid": np.asarray(self.fit_valid),
        }

    @classmethod
    def from_state(cls, state):
        from pisa_tpu_torch.core.binning import MultiDimBinning

        hs = cls(
            binning=MultiDimBinning.from_state(state["binning"]),
            param_names=state["param_names"],
            func_names=state["func_names"],
            nominal_values=state["nominal_values"],
            log=state["log"],
            using_legacy_data=state["using_legacy_data"],
        )
        hs.intercept = np.asarray(state["intercept"], dtype=FTYPE)
        hs.coeffts = {
            k: np.asarray(v, dtype=FTYPE) for k, v in state["coeffts"].items()
        }
        if state.get("fit_cov_mat") is not None:
            hs.fit_cov_mat = np.asarray(state["fit_cov_mat"])
        hs.fit_valid = np.asarray(state["fit_valid"], dtype=bool)
        return hs

    def to_json(self, path):
        to_json(self.state, path)

    @classmethod
    def from_json(cls, path):
        return cls.from_state(from_json(path))


def _fit_inputs(prep, device, y=None, w=None):
    """The fitter's arguments on `device` from a prep (or its y, w)."""
    device = resolve_device(device)

    def up(a):
        return torch.as_tensor(np.asarray(a), dtype=TORCH_FTYPE, device=device)

    y = prep["y"] if y is None else y
    w = prep["w"] if w is None else w
    return (up(y), up(w), up(prep["theta0"]),
            tuple(up(s) for s in prep["shifted"]))


def _read_fit(result):
    """(theta, cov) on the host as float64, in one copy."""
    theta, cov = result
    flat = torch.cat([theta.reshape(-1), cov.reshape(-1)]).cpu().numpy()
    return (flat[:theta.numel()].reshape(theta.shape).astype(np.float64),
            flat[theta.numel():].reshape(cov.shape).astype(np.float64))


def prepare_fit_from_maps(
    nominal_mapset,
    nominal_param_values,
    sys_mapsets,
    sys_param_values,
    binning,
    params,
    log=False,
    norm=True,
    include_nominal=True,
):
    """The host half of :func:`fit_hypersurfaces_from_maps`: (surfaces,
    preps, the datasets' param values, y and w with the maps' bins end to
    end)."""
    datasets = list(zip(sys_mapsets, sys_param_values))
    if include_nominal:
        datasets = [(nominal_mapset, nominal_param_values)] + datasets
    pv_list = [pv for _, pv in datasets]
    surfaces, preps = [], []
    for m_nom in nominal_mapset:
        hs = Hypersurface(
            binning=binning,
            param_names=list(params.keys()),
            func_names=params,
            log=log,
        )
        preps.append(
            hs._prepare_fit_arrays(
                nominal_map=m_nom,
                nominal_param_values=nominal_param_values,
                sys_maps=[ms[m_nom.name] for ms, _ in datasets],
                sys_param_values=pv_list,
                norm=norm,
            )
        )
        surfaces.append(hs)
    y_all = np.concatenate([p["y"] for p in preps], axis=1)
    w_all = np.concatenate([p["w"] for p in preps], axis=1)
    return surfaces, preps, pv_list, y_all, w_all


def fit_hypersurfaces_from_maps(
    nominal_mapset,
    nominal_param_values,
    sys_mapsets,
    sys_param_values,
    binning,
    params,
    log=False,
    norm=True,
    include_nominal=True,
    device="cuda",
):
    """Fit one Hypersurface per map name (reference ``fit_hypersurfaces``,
    ``hypersurface.py:1598``, with datasets given directly as MapSets).

    The maps' bins are fitted together: one fitter call over all of them on
    `device`, one copy of its results to the host.

    Parameters
    ----------
    nominal_mapset : MapSet
    nominal_param_values : dict
    sys_mapsets : list of MapSet
    sys_param_values : list of dict
    binning : MultiDimBinning
    params : dict name -> functional-form name
    """
    surfaces, preps, pv_list, y_all, w_all = prepare_fit_from_maps(
        nominal_mapset, nominal_param_values, sys_mapsets, sys_param_values,
        binning, params, log=log, norm=norm, include_nominal=include_nominal)
    fitter = surfaces[0]._fitter()
    theta, cov = _read_fit(fitter(*_fit_inputs(preps[0], device, y_all,
                                               w_all)))
    out = OrderedDict()
    ofs = 0
    for m_nom, hs, prep in zip(nominal_mapset, surfaces, preps):
        B = hs.binning.size
        hs._ingest_fit(
            theta[ofs:ofs + B], cov[ofs:ofs + B], prep, pv_list
        )
        ofs += B
        out[m_nom.name] = hs
    return out


def evaluate_stacked(surfaces, param_values, device, cache, lanes=None,
                     return_uncertainty=False):
    """The scale factors of several hypersurfaces over the same params and
    bins as one ``(G, B)`` tensor on `device` (a category-stacked
    container's groups, ``stages/discr_sys/hypersurfaces.py``), with
    `return_uncertainty` also their uncertainties (as
    :meth:`Hypersurface.evaluate`). `param_values` maps each systematic to
    a float or a 0-d tensor on `device`, or with `lanes` to a (lanes, 1)
    tensor, and the results are then (lanes, G, B); `cache` (a dict the
    caller keeps) holds the stacked coefficients, uploaded once.

    Linear surfaces out of log space without the uncertainty (the data
    release's hyperplanes) take one product for all of them: ``intercepts
    + slopes . p``; any other form goes through each param's term."""
    names = surfaces[0].param_names
    forms = surfaces[0].forms
    log = surfaces[0].log
    if any(s.param_names != names or s.forms != forms or s.log != log
           for s in surfaces[1:]):
        raise ValueError("hypersurfaces over different params or forms")
    linear = (not log and not return_uncertainty
              and all(f == "linear" for f in forms))
    key = (tuple(id(s) for s in surfaces), device, linear)
    if key not in cache:
        arrays = [s._finite_arrays() for s in surfaces]
        theta = np.stack([a[0] for a in arrays])  # (G, B, n)
        nominal = np.stack([s._nominal_vector() for s in surfaces])  # (G, P)

        def up(a, dtype=TORCH_FTYPE):
            return torch.as_tensor(a, dtype=dtype, device=device)

        entry = {"nominal": None, "finite": None, "cov": None}
        if np.any(nominal != 0):
            entry["nominal"] = up(nominal)
        if any(a[2] is not None for a in arrays):
            entry["finite"] = up(np.stack([
                np.ones(len(a[0]), dtype=bool) if a[2] is None else a[2]
                for a in arrays]), torch.bool)
        if linear:
            entry["coeffts"] = up(theta.transpose(0, 2, 1))  # (G, 1 + P, B)
        else:
            entry["theta"] = up(theta)
            if all(a[1] is not None for a in arrays):
                entry["cov"] = up(np.stack([a[1] for a in arrays]))
        cache[key] = entry
    entry = cache[key]
    p = torch.stack([_param_tensor(param_values[name], device, lanes)
                     for name in names], dim=-1)  # (..., P)
    if linear:
        coeffts = entry["coeffts"]
        if entry["nominal"] is None:
            total = coeffts[:, 0] + torch.einsum("gpb,...p->...gb",
                                                 coeffts[:, 1:], p)
        else:
            shifted = p[..., None, :] - entry["nominal"]  # (..., G, P)
            total = coeffts[:, 0] + torch.einsum("gpb,...gp->...gb",
                                                 coeffts[:, 1:], shifted)
        return _scale_and_sigma(total, None, None, entry["finite"], False,
                                False)
    shifted = p[..., None, :].expand(p.shape[:-1] + (len(surfaces),
                                                     len(names)))
    if entry["nominal"] is not None:
        shifted = shifted - entry["nominal"]
    # each param's value per group, broadcast over the bins: (..., G, 1)
    total, grad = _surface_and_jacobian(
        forms, entry["theta"], [shifted[..., k, None]
                                for k in range(len(names))],
        return_uncertainty)
    return _scale_and_sigma(total, grad, entry["cov"], entry["finite"], log,
                            return_uncertainty)


# -- loading -------------------------------------------------------------------
def load_hypersurfaces(input_file, expected_binning=None):
    """Load hypersurfaces from a fitted JSON file (``.json`` or
    ``.json.bz2``, :func:`save_hypersurfaces`) or the official data-release
    CSV format (reference ``hypersurface.py:1887-2180``).

    Returns OrderedDict map_name -> Hypersurface.
    """
    if input_file.endswith((".csv", ".csv.bz2")):
        return _load_hypersurfaces_data_release(input_file, expected_binning)

    state = from_json(find_resource(input_file))
    out = OrderedDict(
        (name, Hypersurface.from_state(s)) for name, s in state.items()
    )
    if expected_binning is not None:
        for hs in out.values():
            if tuple(hs.binning.shape) != tuple(expected_binning.shape):
                raise ValueError(
                    "hypersurface binning does not match expected binning"
                )
    return out


def save_hypersurfaces(hypersurfaces, path):
    to_json({k: hs.state for k, hs in hypersurfaces.items()}, path)


_DATA_RELEASE_KEYS = {
    "nue_cc+nuebar_cc": "nue_cc",
    "numu_cc+numubar_cc": "numu_cc",
    "nutau_cc+nutaubar_cc": "nutau_cc",
    "nu_nc+nubar_nc": "all_nc",
}


def _load_hypersurfaces_data_release(prototype, binning):
    """Official data-release linear hyperplanes: one CSV per merged category
    (``*`` in `prototype` stands for the category tag), with columns for the
    bin centers, ``offset`` and one slope per systematic, rows in the
    binning's flat order (reference ``hypersurface.py:2065``). Evaluation
    uses *raw* param values (legacy semantics). Read with bz2 and numpy."""
    if binning is None:
        raise ValueError(
            "must provide binning when loading data-release hypersurfaces"
        )
    out = OrderedDict()
    param_names = None
    for map_name, tag in _DATA_RELEASE_KEYS.items():
        table = read_csv(prototype.replace("*", tag))
        for n in binning.names:
            centers_found = np.unique(table.pop(n))
            if centers_found.size != binning[n].num_bins:
                raise ValueError(f"binning mismatch in {tag} for dimension {n}")
        offset = table.pop("offset")
        if param_names is None:
            param_names = list(table)
        elif param_names != list(table):
            raise ValueError("param mismatch between hypersurface files")
        hs = Hypersurface(
            binning=binning,
            param_names=param_names,
            func_names={n: "linear" for n in param_names},
            nominal_values={n: np.nan for n in param_names},
            using_legacy_data=True,
        )
        hs.intercept = offset.reshape(-1).astype(FTYPE)
        hs.coeffts = {name: table[name].reshape(-1, 1).astype(FTYPE)
                      for name in param_names}
        out[map_name] = hs
    return out


# -- interpolated hypersurfaces ------------------------------------------------
class HypersurfaceInterpolator:
    """Interpolate fitted hypersurface coefficients across (oscillation)
    parameters on a rectilinear grid (reference
    ``pisa/utils/hypersurface/hyper_interpolator.py:48``): piecewise-linear
    ``scipy.interpolate.RegularGridInterpolator`` on the host over the
    packed per-bin coefficient vectors (and covariances), producing a
    :class:`Hypersurface` at any point.

    Parameters
    ----------
    interpolation_param_spec : dict (ordered)
        {name: {"values": [...], "scales_log": bool}}
    hs_fits : list of Hypersurface
        one per grid point, ordered as np.ndindex over the grid shape.
    ignore_nan : bool
        replace non-finite fits by identity (intercept 1, slopes 0).
    """

    def __init__(self, interpolation_param_spec, hs_fits, ignore_nan=True):
        from scipy.interpolate import RegularGridInterpolator

        self.interp_param_spec = OrderedDict(interpolation_param_spec)
        self.grid_values = [
            np.asarray(
                [getattr(v, "magnitude", v) for v in spec["values"]],
                dtype=np.float64,
            )
            for spec in self.interp_param_spec.values()
        ]
        self.scales_log = [
            bool(spec.get("scales_log", False))
            for spec in self.interp_param_spec.values()
        ]
        grid_axes = [
            np.log10(v) if lg else v
            for v, lg in zip(self.grid_values, self.scales_log)
        ]
        interp_shape = tuple(len(v) for v in self.grid_values)
        if int(np.prod(interp_shape)) != len(hs_fits):
            raise ValueError(
                f"need {int(np.prod(interp_shape))} fits for grid"
                f" {interp_shape}; got {len(hs_fits)}"
            )

        self._reference = hs_fits[0]
        thetas = np.stack(
            [hs._packed_theta() for hs in hs_fits]
        ).reshape(interp_shape + hs_fits[0]._packed_theta().shape)
        if ignore_nan:
            bad = ~np.isfinite(thetas)
            # identity surface: intercept 1 (exp(0) in log mode), slopes 0
            fill = np.zeros_like(thetas)
            fill[..., 0] = 0.0 if self._reference.log else 1.0
            thetas = np.where(bad, fill, thetas)
        self._theta_interp = RegularGridInterpolator(
            grid_axes, thetas, bounds_error=False, fill_value=None
        )
        covs = [
            hs.fit_cov_mat
            if hs.fit_cov_mat is not None
            else np.zeros(
                (hs.binning.size, hs.num_coeffts, hs.num_coeffts)
            )
            for hs in hs_fits
        ]
        covs = np.stack(covs).reshape(interp_shape + covs[0].shape)
        covs = np.nan_to_num(covs)
        self._cov_interp = RegularGridInterpolator(
            grid_axes, covs, bounds_error=False, fill_value=None
        )

    @property
    def interpolation_param_names(self):
        return list(self.interp_param_spec.keys())

    @property
    def param_names(self):
        return self._reference.param_names

    @property
    def binning(self):
        return self._reference.binning

    def get_hypersurface(self, **param_kw):
        """Hypersurface at the given interpolation-param point (values may
        be Quantities or plain host magnitudes)."""
        point = []
        for name, lg in zip(self.interpolation_param_names, self.scales_log):
            if name not in param_kw:
                raise ValueError(f"missing interpolation param {name!r}")
            v = param_kw[name]
            v = getattr(v, "magnitude", v)
            v = float(np.asarray(v))
            point.append(np.log10(v) if lg else v)
        theta = np.asarray(self._theta_interp([point])[0])
        cov = np.asarray(self._cov_interp([point])[0])

        hs = Hypersurface(
            binning=self._reference.binning,
            param_names=self._reference.param_names,
            func_names=self._reference.func_names,
            nominal_values=self._reference.nominal_values,
            log=self._reference.log,
            using_legacy_data=self._reference.using_legacy_data,
        )
        hs.intercept = theta[:, 0].astype(FTYPE)
        _, blocks = hs._unpack(theta)
        hs.coeffts = {k: np.asarray(v, dtype=FTYPE) for k, v in blocks.items()}
        hs.fit_cov_mat = cov
        hs.fit_valid = np.isfinite(theta).all(axis=1)
        return hs

    # -- serialization ----------------------------------------------------------
    @property
    def state(self):
        spec = OrderedDict(
            (
                name,
                {
                    "values": list(vals),
                    "scales_log": lg,
                },
            )
            for name, vals, lg in zip(
                self.interpolation_param_names, self.grid_values,
                self.scales_log,
            )
        )
        return {"interp_param_spec": spec, "hs_fits": self._hs_fit_states}

    @classmethod
    def from_fits(cls, interpolation_param_spec, hs_fits, **kw):
        obj = cls(interpolation_param_spec, hs_fits, **kw)
        obj._hs_fit_states = [hs.state for hs in hs_fits]
        return obj


def save_interpolated_hypersurfaces(interpolators, path):
    """Serialize {map_name: HypersurfaceInterpolator} (built via
    ``HypersurfaceInterpolator.from_fits``) to JSON."""
    to_json({k: v.state for k, v in interpolators.items()}, path)


def load_interpolated_hypersurfaces(input_file, expected_binning=None):
    """Load interpolated hypersurfaces (reference
    ``hyper_interpolator.py:920``). Returns
    OrderedDict map_name -> HypersurfaceInterpolator."""
    state = from_json(find_resource(input_file))
    out = OrderedDict()
    for name, s in state.items():
        fits = [Hypersurface.from_state(f) for f in s["hs_fits"]]
        interp = HypersurfaceInterpolator.from_fits(
            s["interp_param_spec"], fits
        )
        if expected_binning is not None and tuple(
            interp.binning.shape
        ) != tuple(expected_binning.shape):
            raise ValueError("binning mismatch in interpolated hypersurfaces")
        out[name] = interp
    return out


# -- interpolated-fit job splitting / resume ----------------------------------
# The reference's re-entrant batch fits (``hyper_interpolator.py:761``
# prepare_interpolated_fit, ``:618`` run_interpolated_fit with its
# skip_successful resume, ``:598`` get_incomplete_job_idx, ``:549``
# assemble_interpolated_fits): one fit directory holds a metadata file and
# one gridpoint file per interpolation grid point; jobs run anywhere (job
# arrays) and resume by index, and the assembled output loads through
# :func:`load_interpolated_hypersurfaces`. The files are the JAX package's.

def _grid_shape(interpolation_param_spec):
    return tuple(
        len(spec["values"]) for spec in interpolation_param_spec.values()
    )


def _gridpoint_path(fit_directory, job_idx):
    return os.path.join(fit_directory, f"gridpoint_{job_idx:06d}.json.bz2")


def prepare_interpolated_fit(
    fit_directory, interpolation_param_spec, fit_cfg
):
    """Lay out a fit directory for per-gridpoint (cluster) execution.

    Parameters
    ----------
    fit_directory : str
        created if missing; receives ``metadata.json`` and one
        ``gridpoint_NNNNNN.json.bz2`` (``fit_successful=False``) per point.
    interpolation_param_spec : ordered dict
        ``{name: {"values": [...], "scales_log": bool}}``: pipeline params
        the hypersurfaces are interpolated over (e.g. ``deltam31``).
    fit_cfg : dict
        the single-point fit configuration of
        ``scripts.fit_hypersurfaces`` (pipeline_cfg, params,
        nominal_dataset/sys_datasets param_values, combine_regex, log, norm).

    Returns the number of jobs (grid points).
    """
    os.makedirs(fit_directory, exist_ok=True)
    spec = OrderedDict(
        (
            name,
            {
                "values": [
                    float(getattr(v, "magnitude", v)) for v in s["values"]
                ],
                "scales_log": bool(s.get("scales_log", False)),
            },
        )
        for name, s in interpolation_param_spec.items()
    )
    grid_shape = _grid_shape(spec)
    metadata = {
        "interpolation_param_spec": spec,
        "interpolation_param_names": list(spec.keys()),
        "grid_shape": list(grid_shape),
        "fit_cfg": fit_cfg,
    }
    to_json(metadata, os.path.join(fit_directory, "metadata.json"))

    names = list(spec.keys())
    n_jobs = 0
    for job_idx, grid_idx in enumerate(np.ndindex(grid_shape)):
        param_values = {
            n: spec[n]["values"][i] for n, i in zip(names, grid_idx)
        }
        to_json(
            {
                "job_idx": job_idx,
                "grid_idx": list(grid_idx),
                "param_values": param_values,
                "fit_successful": False,
                "hs_fit": None,
            },
            _gridpoint_path(fit_directory, job_idx),
        )
        n_jobs += 1
    logging.info(
        "prepared %d interpolated-fit jobs in %s", n_jobs, fit_directory
    )
    return n_jobs


def run_interpolated_fit(fit_directory, job_idx, skip_successful=False,
                         device="cuda"):
    """Fit hypersurfaces at one grid point (its pipeline on `device`) and
    store the result.

    With ``skip_successful=True`` a completed job is a no-op, so failed job
    arrays can simply be resubmitted over the full index range."""
    gridpoint_path = _gridpoint_path(fit_directory, job_idx)
    gridpoint = from_json(gridpoint_path)
    if skip_successful and gridpoint.get("fit_successful"):
        logging.info("job %d already successful; skipping", job_idx)
        return

    metadata = from_json(os.path.join(fit_directory, "metadata.json"))
    fit_cfg = metadata["fit_cfg"]
    param_values = gridpoint["param_values"]

    # consistency: stored values must match the grid point's coordinates
    spec = metadata["interpolation_param_spec"]
    grid_idx = tuple(gridpoint["grid_idx"])
    for i, n in enumerate(metadata["interpolation_param_names"]):
        expect = spec[n]["values"][grid_idx[i]]
        if not np.isclose(param_values[n], expect):
            raise ValueError(
                f"inconsistent values at grid point {grid_idx}: "
                f"{param_values[n]} != {expect}"
            )

    from pisa_tpu_torch.scripts.fit_hypersurfaces import (
        fit_hypersurfaces_from_pipeline,
    )

    # interpolation-param values override every dataset's param_values
    nominal = dict(fit_cfg["nominal_dataset"]["param_values"])
    nominal.update(param_values)
    sys_values = []
    for d in fit_cfg["sys_datasets"]:
        pv = dict(d["param_values"])
        pv.update(param_values)
        sys_values.append(pv)

    surfaces = fit_hypersurfaces_from_pipeline(
        pipeline_cfg=fit_cfg["pipeline_cfg"],
        params=fit_cfg["params"],
        nominal_param_values=nominal,
        sys_param_values=sys_values,
        combine_regex=fit_cfg.get("combine_regex"),
        log=fit_cfg.get("log", False),
        norm=fit_cfg.get("norm", True),
        device=device,
    )
    gridpoint["hs_fit"] = {k: hs.state for k, hs in surfaces.items()}
    gridpoint["fit_successful"] = True
    to_json(gridpoint, gridpoint_path)
    logging.info("job %d fit complete", job_idx)


def get_incomplete_job_idx(fit_directory):
    """Indices of grid points not yet flagged fit_successful
    (reference ``hyper_interpolator.py:598``)."""
    metadata = from_json(os.path.join(fit_directory, "metadata.json"))
    incomplete = []
    for job_idx in range(int(np.prod(metadata["grid_shape"]))):
        try:
            gridpoint = from_json(_gridpoint_path(fit_directory, job_idx))
        except Exception:
            incomplete.append(job_idx)
            continue
        if not gridpoint.get("fit_successful"):
            incomplete.append(job_idx)
    return incomplete


def assemble_interpolated_fits(
    fit_directory, output_file, drop_fit_maps=False
):
    """Combine completed gridpoint fits into one file loadable by
    :func:`load_interpolated_hypersurfaces`
    (reference ``hyper_interpolator.py:549``). ``drop_fit_maps`` is
    accepted for the reference's signature (the states hold no fit maps)."""
    metadata = from_json(os.path.join(fit_directory, "metadata.json"))
    spec = metadata["interpolation_param_spec"]
    grid_shape = tuple(metadata["grid_shape"])

    per_map = None
    for job_idx, grid_idx in enumerate(np.ndindex(grid_shape)):
        gridpoint = from_json(_gridpoint_path(fit_directory, job_idx))
        if gridpoint["job_idx"] != job_idx or tuple(
            gridpoint["grid_idx"]
        ) != tuple(grid_idx):
            raise ValueError(f"corrupt gridpoint file for job {job_idx}")
        if not gridpoint.get("fit_successful"):
            raise ValueError(
                f"job {job_idx} not finished; rerun it via"
                " run_interpolated_fit(..., skip_successful=True)"
            )
        if per_map is None:
            per_map = OrderedDict(
                (name, []) for name in gridpoint["hs_fit"]
            )
        for name, hs_state in gridpoint["hs_fit"].items():
            per_map[name].append(hs_state)

    out = OrderedDict(
        (
            name,
            {"interp_param_spec": spec, "hs_fits": states},
        )
        for name, states in per_map.items()
    )
    to_json(out, output_file)
    logging.info(
        "assembled %d gridpoint fits -> %s",
        int(np.prod(grid_shape)),
        output_file,
    )
