"""
Host copy of ``pisa_tpu/analysis/minimizer_config.py`` with its imports
rewritten to ``pisa_tpu_torch``; the settings files are read in place under
``pisa_tpu/resources/settings/minimizer``.

Minimizer settings-file handling (cf. reference
``pisa/analysis/configure_scipy_minimization.py:23-274``): the
{'method': {'value', 'desc'}, 'options': {'value', 'desc'}} JSON schema
used by the reference's ``settings/minimizer/*.json`` files, FTYPE-aware
defaults, validity checks (required/allowed option keys; eps/ftol vs
machine-epsilon consistency), and translation into the ``method_kwargs``
dict consumed by :meth:`BasicAnalysis._fit_scipy`.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.utils.log import logging

__all__ = [
    "set_minimizer_defaults",
    "validate_minimizer_settings",
    "load_minimizer_settings",
    "make_scipy_constraint_dict",
]

_OPTION_KEYS = {
    "l-bfgs-b": (
        ("maxcor", "ftol", "gtol", "eps", "maxfun", "maxiter", "maxls"),
        ("args", "jac", "bounds", "disp", "iprint", "callback"),
    ),
    "slsqp": (
        ("maxiter", "ftol", "eps"),
        ("args", "jac", "bounds", "constraints", "iprint", "disp",
         "callback"),
    ),
    "cobyla": (
        ("maxiter", "rhobeg", "tol"),
        ("disp", "catol", "constraints"),
    ),
    "trust-constr": (
        ("maxiter", "gtol", "xtol", "barrier_tol"),
        ("sparse_jacobian", "initial_tr_radius", "initial_constr_penalty",
         "constraints", "initial_barrier_parameter",
         "initial_barrier_tolerance", "factorization_method",
         "finite_diff_rel_step", "verbose", "disp"),
    ),
    "nelder-mead": (
        ("maxfev", "xatol", "fatol"),
        ("disp", "maxiter", "return_all", "initial_simplex", "adaptive",
         "bounds"),
    ),
}


def set_minimizer_defaults(minimizer_settings):
    """Fill in FTYPE-aware default options (reference
    ``configure_scipy_minimization.py:37``)."""
    out = {
        "method": {"value": "", "desc": ""},
        "options": {"value": {}, "desc": {}},
    }
    out.update(deepcopy(minimizer_settings))

    sqrt_eps = float(np.sqrt(np.finfo(FTYPE).eps))
    method = out["method"]["value"].lower()
    fp64 = FTYPE == np.float64

    if method == "l-bfgs-b":
        defaults = {
            "maxcor": 10,
            "ftol": 2.2204460492503131e-09 if fp64 else sqrt_eps,
            "gtol": 1e-5 if fp64 else 1e-3,
            "eps": 1e-8 if fp64 else 1e-5,
            "maxfun": 15000,
            "maxiter": 15000,
            "maxls": 20,
        }
    elif method == "slsqp":
        defaults = {
            "maxiter": 100,
            "ftol": 1e-6 if fp64 else 1e-4,
            "iprint": 0,
            "eps": sqrt_eps,
        }
    elif method == "cobyla":
        defaults = {"rhobeg": 0.1, "maxiter": 1000, "tol": 1e-4}
    elif method == "trust-constr":
        defaults = {
            "maxiter": 200, "gtol": 1e-4, "xtol": 1e-4, "barrier_tol": 1e-4,
        }
    elif method == "nelder-mead":
        defaults = {"maxfev": 1000, "xatol": 1e-4, "fatol": 1e-4}
    else:
        raise ValueError(f"Unhandled minimizer {method!r} / FTYPE={FTYPE}")

    defaults.update(out["options"]["value"])
    out["options"]["value"] = defaults
    for opt in defaults:
        out["options"]["desc"].setdefault(opt, "no desc")
    return out


def validate_minimizer_settings(minimizer_settings):
    """Raise on invalid / inconsistent settings, warn on marginal ones
    (reference ``configure_scipy_minimization.py:133``)."""
    ftype_eps = float(np.finfo(FTYPE).eps)
    fp64_eps = float(np.finfo(np.float64).eps)
    method = minimizer_settings["method"]["value"].lower()
    options = minimizer_settings["options"]["value"]

    if method not in _OPTION_KEYS:
        raise ValueError(f"Unhandled minimizer {method!r}")
    must_have, extra = _OPTION_KEYS[method]
    may_have = set(must_have) | set(extra)
    missing = set(must_have) - set(options)
    excess = set(options) - may_have
    if missing:
        raise ValueError(
            f"Missing the following options for {method} minimizer:"
            f" {sorted(missing)}"
        )
    if excess:
        raise ValueError(
            f"Excess options for {method} minimizer: {sorted(excess)}"
        )

    eps_msg = "%s minimizer option %s(=%e) is < %d * %s_EPS(=%e)"
    eps_gt_msg = "%s minimizer option %s(=%e) is > %e"

    def check_tol(name, val):
        if val < 2 * ftype_eps:
            raise ValueError(
                eps_msg % (method, name, val, 2, "FTYPE", ftype_eps)
            )
        if val < 10 * ftype_eps:
            logging.warning(
                eps_msg, method, name, val, 10, "FTYPE", ftype_eps
            )

    def check_eps(val):
        if val < fp64_eps:
            raise ValueError(
                eps_msg % (method, "eps", val, 1, "FP64", fp64_eps)
            )
        if val < 10 * ftype_eps:
            logging.warning(
                eps_msg, method, "eps", val, 10, "FTYPE", ftype_eps
            )
        if val > 0.25:
            raise ValueError(eps_gt_msg % (method, "eps", val, 0.25))
        if val > 0.1:
            logging.warning(eps_gt_msg, method, "eps", val, 0.1)

    if method == "l-bfgs-b":
        check_tol("ftol", options["ftol"])
        check_tol("gtol", options["gtol"])
        check_eps(options["eps"])
    elif method == "slsqp":
        check_tol("ftol", options["ftol"])
        check_eps(options["eps"])
    elif method == "cobyla":
        if options["rhobeg"] > 0.5:
            raise ValueError(
                "starting step-size > 0.5 will overstep boundary"
            )
        if options["rhobeg"] < 1e-2:
            logging.warning(
                "starting step-size is very low, convergence will be slow"
            )


def load_minimizer_settings(settings):
    """Load + default + validate settings; returns the ``method_kwargs``
    dict for :meth:`BasicAnalysis._fit_scipy` ({'method', 'options'}).

    `settings` may be a path to a reference-schema JSON file, a dict in
    that schema, or an already-flat {'method': str, 'options': dict}.
    """
    if isinstance(settings, str):
        from pisa_tpu_torch.utils.fileio import from_file
        from pisa_tpu_torch.utils.resources import find_resource

        settings = from_file(find_resource(settings))
    settings = deepcopy(dict(settings))
    if isinstance(settings.get("method"), str):
        # already-flat form: wrap into the reference schema for validation
        settings = {
            "method": {"value": settings["method"], "desc": ""},
            "options": {"value": settings.get("options", {}), "desc": {}},
        }
    settings = set_minimizer_defaults(settings)
    validate_minimizer_settings(settings)
    options = dict(settings["options"]["value"])
    options.pop("iprint", None)  # not accepted by every scipy version
    return {
        "method": settings["method"]["value"].lower(),
        "options": options,
    }


def make_scipy_constraint_dict(constr_type, fun, jac=None, args=None):
    """Scipy-format constraint dict (reference
    ``configure_scipy_minimization.py:258``)."""
    if constr_type not in ("eq", "ineq"):
        raise ValueError(f"constraint type must be eq/ineq, not {constr_type}")
    if not callable(fun):
        raise TypeError(
            f"Constraint function has to be callable, not {type(fun)}."
        )
    out = {"type": constr_type, "fun": fun}
    if jac is not None:
        if not callable(jac):
            raise TypeError(f"Jacobian has to be callable, not {type(jac)}.")
        out["jac"] = jac
    if args is not None:
        out["args"] = tuple(args)
    return out
