"""
Analysis: fitting hypothesis templates to data distributions.

Counterpart of ``pisa_tpu/analysis/analysis.py`` (reference
``pisa/analysis/analysis.py:121,486,854``). Fit methods, dispatched by
:meth:`BasicAnalysis.fit_recursively`:

- 'scipy'    : scipy.optimize local and global minimizers over the [0, 1]
               rescaled free-param space (``_fit_scipy``); gradient-based
               algorithms take the analytic gradient of the compiled
               objective (``analysis/gradient.py``).
- 'gradient' : the compiled value and gradient into scipy
               L-BFGS-B/SLSQP/trust-constr.
- 'device'   : the whole L-BFGS loop with its state on the hypo maker's
               device (``analysis/device_fit.py``).
- 'iminuit'  : L-BFGS-B with the analytic gradient, then a Hesse step
               (errors from central differences of the analytic gradient).
- 'nlopt'    : the NLopt algorithm vocabulary: the derivative-free names
               through the ``nlopt`` API (the real package where it is
               installed, else the scipy-backed shim
               ``utils/nlopt_shim.py``), the gradient names (LD_/GD_)
               translated to the native scipy fits with the analytic
               gradient.
- 'octants', 'best_of', 'ranges', 'grid_scan', 'condition', 'staged',
  'constrained': recursive strategies as in the reference.

The objective follows the reference's convention: the metric summed over
maps plus the prior penalties, sign-flipped for llh-family metrics, so that
it is always minimized (``analysis.py:2493,2545-2556``). On a CUDA device
each compiled objective is one captured program
(:class:`~pisa_tpu_torch.analysis.gradient.CompiledDistribution`), and a
scipy evaluation reads its value and gradient in one copy.

Not ported yet (ROADMAP queue 1, item 14; it raises
``NotImplementedError``): the route through the real ``iminuit`` package,
which is installed nowhere the port runs.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import scipy.optimize as spo
import torch

from pisa_tpu_torch import ureg
from pisa_tpu_torch.core.container import resolve_device
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.core.param import ParamSet
from pisa_tpu_torch.utils import stats
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.analysis.manipulate_params import (
    BoundedRandomDisplacement,
    get_separate_octant_params,
    update_param_values,
)

__all__ = ["Counter", "HypoFitResult", "BasicAnalysis", "Analysis"]

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 14)"

#: fixed params whose value a stage writes as a result of an evaluation
#: (daemon_flux's covariance chi2), not an input of the compiled objective:
#: they stay out of the compiled-distribution cache's key, which would
#: otherwise change at every eager evaluation (the JAX package's
#: ``analysis.py:286`` keeps them in, and recompiles each fit)
_RESULT_PARAMS = frozenset({"daemon_chi2"})

LOCAL_SCIPY_METHODS = (
    "l-bfgs-b",
    "slsqp",
    "nelder-mead",
    "cobyla",
    "powell",
    "trust-constr",
)
GLOBAL_SCIPY_METHODS = (
    "basinhopping",
    "differential_evolution",
    "dual_annealing",
    "shgo",
    "direct",
)
GRADIENT_METHODS = ("l-bfgs-b", "slsqp", "trust-constr")


class Counter:
    """Mutable call counter (cf. reference ``analysis.py:97``)."""

    def __init__(self, i=0):
        self._count = i

    def __iadd__(self, inc):
        self._count += inc
        return self

    def reset(self):
        self._count = 0

    @property
    def count(self):
        return self._count

    def __int__(self):
        return self._count

    def __str__(self):
        return str(self._count)


class HypoFitResult:
    """Record of a single hypothesis fit (cf. reference ``analysis.py:121``)."""

    _state_attrs = (
        "metric",
        "metric_val",
        "params",
        "param_selections",
        "hypo_asimov_dist",
        "detailed_metric_info",
        "minimizer_time",
        "num_distributions_generated",
        "minimizer_metadata",
        "fit_history",
    )

    def __init__(
        self,
        metric=None,
        metric_val=None,
        data_dist=None,
        hypo_maker=None,
        minimizer_time=None,
        minimizer_metadata=None,
        fit_history=None,
        num_distributions_generated=None,
        include_detailed_metric_info=False,
        counter=None,
    ):
        self.metric = metric
        self.metric_val = metric_val
        self.param_selections = None
        self.params = None
        self.hypo_asimov_dist = None
        self.detailed_metric_info = None
        self.minimizer_time = (
            minimizer_time * ureg.sec if minimizer_time is not None else None
        )
        self.minimizer_metadata = minimizer_metadata
        self.fit_history = fit_history
        self.num_distributions_generated = (
            num_distributions_generated
            if num_distributions_generated is not None
            else (int(counter) if counter is not None else None)
        )

        if hypo_maker is not None:
            self.params = ParamSet(
                [_copy_param(p) for p in hypo_maker.params]
            )
            self.param_selections = list(
                getattr(hypo_maker, "param_selections", [])
            )
            # regenerate the best-fit distribution (cf. reference :177)
            self.hypo_asimov_dist = hypo_maker.get_outputs(return_sum=True)
        if (
            include_detailed_metric_info
            and data_dist is not None
            and self.hypo_asimov_dist is not None
        ):
            self.detailed_metric_info = self.get_detailed_metric_info(
                data_dist, self.hypo_asimov_dist, hypo_maker.params, metric
            )

    @staticmethod
    def get_detailed_metric_info(data_dist, hypo_asimov_dist, params, metric):
        """Per-map metric contributions + prior penalties
        (cf. reference ``analysis.py:373``)."""
        if isinstance(metric, (list, tuple)):
            metric = metric[0]
        info = OrderedDict()
        if isinstance(data_dist, MapSet) and isinstance(
            hypo_asimov_dist, MapSet
        ):
            info["maps"] = data_dist.metric_per_map(hypo_asimov_dist, metric)
        priors = params.priors_penalties(metric)
        info["priors"] = dict(zip(params.names, priors))
        info["metric"] = metric
        return info

    @property
    def state(self):
        state = OrderedDict()
        for attr in self._state_attrs:
            val = getattr(self, attr)
            if attr == "params" and val is not None:
                val = val.state
            elif attr == "hypo_asimov_dist" and val is not None:
                val = (
                    [m.state for m in val]
                    if isinstance(val, MapSet)
                    else val
                )
            state[attr] = val
        return state

    @classmethod
    def from_state(cls, state):
        obj = cls()
        for attr in cls._state_attrs:
            if attr in state:
                setattr(obj, attr, state[attr])
        return obj

    def __str__(self):
        return (
            f"HypoFitResult(metric={self.metric},"
            f" metric_val={self.metric_val},"
            f" n_distributions={self.num_distributions_generated})"
        )

    __repr__ = __str__


def _import_nlopt():
    """The real ``nlopt`` package where it is importable, else the port's
    scipy-backed shim with the same API (:mod:`pisa_tpu_torch.utils.
    nlopt_shim`), so that the reference's whole fit schema (reference
    ``analysis.py:2218-2470``) runs either way
    (``pisa_tpu/analysis/analysis.py:203``). ``PISA_TPU_NLOPT_SHIM=1``
    forces the shim."""
    import os

    if os.environ.get("PISA_TPU_NLOPT_SHIM", "0") != "1":
        try:
            import nlopt

            return nlopt
        except ImportError:
            pass
    from pisa_tpu_torch.utils import nlopt_shim

    return nlopt_shim


def _copy_param(p):
    """Deep-copy a Param without sharing identity."""
    from pisa_tpu_torch.core.param import DerivedParam, Param

    if isinstance(p, DerivedParam):
        new = DerivedParam(
            name=p.name,
            value=p.value,
            depends_names=p.depends_names,
            function=p.function,
            tex=p._tex,
        )
        return new
    new = Param(
        name=p.name,
        value=p.value,
        prior=p.prior,
        range=p.range,
        is_fixed=p.is_fixed,
        is_discrete=p.is_discrete,
        scales_as_log=p.scales_as_log,
        tex=p._tex,
    )
    # bypass validation: the nominal may lie outside a temporarily-restricted
    # range (e.g. during octant fits; cf. reference analysis.py:1054-1062)
    new._nominal_value = p.nominal_value
    return new


def _read(value_and_grad):
    """A (value, gradient) pair of tensors on the host in one copy (the one
    wait of an evaluation on the card): (float, float64 array)."""
    value, grad = value_and_grad
    host = torch.cat([value.reshape(1).to(grad.dtype), grad]).cpu()
    host = host.numpy().astype(np.float64)
    return float(host[0]), host[1:]


class BasicAnalysis:
    """The fits and their strategies (cf. reference
    ``analysis.py:486,2685``)."""

    # compiled objectives are keyed on the hypo maker identity + trace-
    # relevant state, so they can safely be shared across Analysis instances
    # (compiling a template objective is expensive)
    _compiled_cache = {}

    def __init__(self):
        self.blindness = False

    # ------------------------------------------------------------------ utils
    @staticmethod
    def _metric_name(metric):
        if isinstance(metric, (list, tuple)):
            metric = metric[0]
        metric = str(metric).strip().lower()
        if metric not in stats.ALL_METRICS:
            raise ValueError(f"Unknown metric {metric!r}")
        return metric

    def _get_compiled(self, hypo_maker):
        """Compiled distribution for `hypo_maker`, rebuilt when the free-param
        set or selections change."""
        from pisa_tpu_torch.analysis.gradient import (
            CompiledDetectors,
            CompiledDistribution,
        )
        from pisa_tpu_torch.core.detectors import Detectors

        key = (
            id(hypo_maker),
            tuple(hypo_maker.params.free.names),
            tuple(getattr(hypo_maker, "param_selections", [])),
            tuple(str(p.value) for p in hypo_maker.params.fixed
                  if p.name not in _RESULT_PARAMS),
            # note: param RANGES are runtime inputs of the compiled objective
            # (CompiledDistribution._current_bounds), so octant/ranges
            # strategies reuse the same executable
        )
        if key not in self._compiled_cache:
            if isinstance(hypo_maker, Detectors):
                self._compiled_cache[key] = CompiledDetectors(hypo_maker)
            else:
                self._compiled_cache[key] = CompiledDistribution(hypo_maker)
        return self._compiled_cache[key]

    def _data_total(self, data_dist):
        if isinstance(data_dist, MapSet):
            return data_dist
        if isinstance(data_dist, Map):
            return MapSet([data_dist])
        if isinstance(data_dist, (list, tuple)):
            return [self._data_total(d) for d in data_dist]
        return data_dist

    @staticmethod
    def _metric_total(data_total, hypo_dist, metric):
        """Metric total; per-detector lists are summed (cf. reference
        ``analysis.py:2591-2601``)."""
        if isinstance(data_total, (list, tuple)):
            return sum(
                BasicAnalysis._metric_total(d, h, metric)
                for d, h in zip(data_total, hypo_dist)
            )
        return data_total.metric_total(hypo_dist, metric)

    # ---------------------------------------------------------------- objective
    def _minimizer_callable(
        self, rescaled_vec, hypo_maker, data_dist, metric, counter, fit_history
    ):
        """Eager objective (cf. reference ``analysis.py:2493``)."""
        metric = self._metric_name(metric)
        hypo_maker._set_rescaled_free_params(rescaled_vec)
        hypo_asimov_dist = hypo_maker.get_outputs(return_sum=True)
        counter += 1

        data_total = self._data_total(data_dist)
        try:
            metric_val = self._metric_total(
                data_total, hypo_asimov_dist, metric
            ) + hypo_maker.params.priors_penalty(metric=metric)
        except Exception:
            logging.exception("Metric evaluation failed")
            metric_val = np.inf if not stats.is_metric_to_maximize(metric) else -np.inf

        sign = -1.0 if stats.is_metric_to_maximize(metric) else +1.0
        out = sign * metric_val
        if fit_history is not None:
            fit_history.append(
                [metric_val] + list(np.asarray(rescaled_vec, dtype=float))
            )
        return out

    # ------------------------------------------------------------- entry point
    def fit_recursively(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method, method_kwargs=None, local_fit_kwargs=None,
    ):
        """Recursive fit dispatch (cf. reference ``analysis.py:854``)."""
        if isinstance(metric, str):
            metric = [metric]

        # shortcut when data == current hypo (cf. reference :928-959)
        fn = getattr(self, f"_fit_{method}", None)
        if fn is None:
            raise ValueError(f"Unknown fit method {method!r}")
        return fn(
            data_dist,
            hypo_maker,
            metric,
            external_priors_penalty,
            method_kwargs or {},
            local_fit_kwargs,
        )

    # alias used by reference-style calls
    def fit_hypo(
        self, data_dist, hypo_maker, metric, minimizer_settings=None, **kw
    ):
        method = (minimizer_settings or {}).get("method", "scipy")
        method_kwargs = (minimizer_settings or {}).get("method_kwargs", {})
        return self.fit_recursively(
            data_dist, hypo_maker, metric, None, method, method_kwargs, None
        )

    # -------------------------------------------------------------- strategies
    def _fit_best_of(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Run several local fits, keep the best (cf. ``analysis.py:1094``)."""
        results = []
        for settings in local_fit_kwargs:
            hypo_maker.reset_free()
            result = self.fit_recursively(
                data_dist, hypo_maker, metric, external_priors_penalty,
                settings["method"], settings.get("method_kwargs"),
                settings.get("local_fit_kwargs"),
            )
            results.append(result)
        best = results[0]
        for r in results[1:]:
            if stats.it_got_better(r.metric_val, best.metric_val, metric[0]):
                best = r
        update_param_values(hypo_maker, best.params.free)
        return best

    def _fit_octants(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Fit both theta23 octants (cf. reference ``analysis.py:974``)."""
        angle_name = method_kwargs.get("angle", "theta23")
        inflection_point = method_kwargs.get(
            "inflection_point", 45 * ureg.degree
        )
        reset_free = method_kwargs.get("reset_free", True)
        if angle_name not in hypo_maker.params.free.names:
            logging.debug(
                "%s not free; running plain inner fit", angle_name
            )
            return self.fit_recursively(
                data_dist, hypo_maker, metric, external_priors_penalty,
                local_fit_kwargs["method"],
                local_fit_kwargs.get("method_kwargs"),
                local_fit_kwargs.get("local_fit_kwargs"),
            )

        octant = get_separate_octant_params(
            hypo_maker, angle_name, inflection_point
        )
        angle = octant["angle"]

        results = []
        for case in ("first", "second"):
            value, vrange = octant[case]
            if reset_free:
                hypo_maker.reset_free()
            angle.range = vrange
            angle.value = value
            result = self.fit_recursively(
                data_dist, hypo_maker, metric, external_priors_penalty,
                local_fit_kwargs["method"],
                local_fit_kwargs.get("method_kwargs"),
                local_fit_kwargs.get("local_fit_kwargs"),
            )
            results.append(result)

        # restore the original range on both fit results & the param
        angle.range = octant["orig_range"]
        best = results[0]
        if stats.it_got_better(
            results[1].metric_val, results[0].metric_val, metric[0]
        ):
            best = results[1]
        # restore best-fit values on the hypo maker
        best.params[angle_name].range = octant["orig_range"]
        update_param_values(hypo_maker, best.params.free)
        return best

    def _fit_ranges(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Partition a param's range into sub-ranges, fit each, keep the best
        (cf. reference ``analysis.py:1396``)."""
        pname = method_kwargs["param_name"]
        splits = method_kwargs["ranges"]
        reset_free = method_kwargs.get("reset_free", True)
        param = hypo_maker.params[pname]
        orig_range = param.range
        orig_value = param.value
        results = []
        for sub in splits:
            if reset_free:
                hypo_maker.reset_free()
            lo, hi = sub
            param.range = (lo, hi)
            mid_val = orig_value
            try:
                param.value = mid_val
            except ValueError:
                param._rescaled_value = 0.5
            result = self.fit_recursively(
                data_dist, hypo_maker, metric, external_priors_penalty,
                local_fit_kwargs["method"],
                local_fit_kwargs.get("method_kwargs"),
                local_fit_kwargs.get("local_fit_kwargs"),
            )
            results.append(result)
        param.range = orig_range
        best = results[0]
        for r in results[1:]:
            if stats.it_got_better(r.metric_val, best.metric_val, metric[0]):
                best = r
        best.params[pname].range = orig_range
        update_param_values(hypo_maker, best.params.free)
        return best

    def _fit_grid_scan(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Scan a grid of param values; optionally refit at each point
        (cf. reference ``analysis.py:1172``)."""
        grid = method_kwargs["grid"]  # dict name -> list of Quantities
        fix_grid_params = method_kwargs.get("fix_grid_params", True)

        names = list(grid.keys())
        meshes = np.meshgrid(
            *[np.arange(len(v)) for v in grid.values()], indexing="ij"
        )
        combos = np.stack([m.ravel() for m in meshes], axis=1)

        orig_fixed = {n: hypo_maker.params[n].is_fixed for n in names}
        results = []
        for combo in combos:
            for n, idx in zip(names, combo):
                hypo_maker.params[n].value = grid[n][int(idx)]
                if fix_grid_params:
                    hypo_maker.params[n].is_fixed = True
            if local_fit_kwargs is not None:
                result = self.fit_recursively(
                    data_dist, hypo_maker, metric, external_priors_penalty,
                    local_fit_kwargs["method"],
                    local_fit_kwargs.get("method_kwargs"),
                    local_fit_kwargs.get("local_fit_kwargs"),
                )
            else:
                result = self._no_fit_result(
                    data_dist, hypo_maker, metric, external_priors_penalty
                )
            results.append(result)
        for n, was_fixed in orig_fixed.items():
            hypo_maker.params[n].is_fixed = was_fixed

        best = results[0]
        for r in results[1:]:
            if stats.it_got_better(r.metric_val, best.metric_val, metric[0]):
                best = r
        best.grid_scan_results = results
        update_param_values(hypo_maker, best.params.free)
        return best

    def _fit_condition(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Pick a fit strategy by evaluating a condition on the hypo maker
        (cf. reference ``analysis.py:1134``)."""
        cond = method_kwargs["condition_func"]
        if isinstance(cond, str):
            cond_fn = eval(cond)  # noqa: S307 - reference-compatible lambda
        else:
            cond_fn = cond
        idx = 0 if cond_fn(hypo_maker) else 1
        settings = local_fit_kwargs[idx]
        return self.fit_recursively(
            data_dist, hypo_maker, metric, external_priors_penalty,
            settings["method"], settings.get("method_kwargs"),
            settings.get("local_fit_kwargs"),
        )

    def _fit_staged(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Sequential fits, each starting from the previous best
        (cf. reference ``analysis.py:1497``)."""
        result = None
        for settings in local_fit_kwargs:
            result = self.fit_recursively(
                data_dist, hypo_maker, metric, external_priors_penalty,
                settings["method"], settings.get("method_kwargs"),
                settings.get("local_fit_kwargs"),
            )
            update_param_values(hypo_maker, result.params.free)
        return result

    def _fit_constrained(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Fit with an equality/inequality constraint expressed over params
        (cf. reference ``analysis.py:1292``); delegates to scipy slsqp."""
        constraint_func = method_kwargs["constraint_func"]
        if isinstance(constraint_func, str):
            expr = constraint_func

            def constraint(vec, hm=hypo_maker):
                hm._set_rescaled_free_params(vec)
                ns = {p.name: p.value.magnitude for p in hm.params}
                ns["np"] = np
                return eval(expr, {"__builtins__": {}}, ns)  # noqa: S307
        else:
            def constraint(vec, hm=hypo_maker):
                hm._set_rescaled_free_params(vec)
                return constraint_func(hm)

        inner = dict(local_fit_kwargs or {})
        inner_kwargs = dict(inner.get("method_kwargs") or {})
        inner_kwargs["constraints"] = [
            {"type": method_kwargs.get("constraint_type", "eq"), "fun": constraint}
        ]
        inner_kwargs.setdefault("method", "slsqp")
        return self._fit_scipy(
            data_dist, hypo_maker, metric, external_priors_penalty,
            inner_kwargs, None,
        )

    # --------------------------------------------------------------- local fits
    def _no_fit_result(
        self, data_dist, hypo_maker, metric, external_priors_penalty
    ):
        """Evaluate the metric at the current params without fitting."""
        metric_name = self._metric_name(metric)
        counter = Counter()
        t0 = time.time()
        hypo = hypo_maker.get_outputs(return_sum=True)
        counter += 1
        data_total = self._data_total(data_dist)
        metric_val = self._metric_total(
            data_total, hypo, metric_name
        ) + hypo_maker.params.priors_penalty(metric=metric_name)
        result = HypoFitResult(
            metric=metric,
            metric_val=metric_val,
            data_dist=data_dist,
            hypo_maker=hypo_maker,
            minimizer_time=time.time() - t0,
            counter=counter,
        )
        return result

    def _fit_scipy(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """scipy.optimize fit over [0,1] rescaled free params
        (cf. reference ``analysis.py:1561``)."""
        method_kwargs = dict(method_kwargs or {})
        algo = str(method_kwargs.pop("method", "l-bfgs-b")).strip().lower()
        options = dict(method_kwargs.pop("options", {}))
        constraints = method_kwargs.pop("constraints", ())
        use_gradient = method_kwargs.pop(
            "gradient", algo in GRADIENT_METHODS
        )
        metric_name = self._metric_name(metric)

        free = hypo_maker.params.free
        if len(free) == 0:
            return self._no_fit_result(
                data_dist, hypo_maker, metric, external_priors_penalty
            )
        x0 = np.asarray(free._rescaled_values, dtype=np.float64)
        bounds = [(0.0, 1.0)] * len(x0)
        counter = Counter()
        fit_history = [["metric"] + list(free.names)]
        t_start = time.time()

        vg = None
        if use_gradient and external_priors_penalty is None:
            try:
                compiled = self._get_compiled(hypo_maker)
                _, vg = compiled.build_objective(
                    self._data_total(data_dist), metric_name
                )
            except Exception as exc:
                logging.info(
                    "Compiled gradient path unavailable (%s); falling back"
                    " to finite differences",
                    exc,
                )
                vg = None

        if vg is not None:
            # Extreme rescaled corners can overflow fp32 templates: values
            # like 1e14 and NaN gradient components. A NaN gradient makes
            # scipy line searches silently give up at x0, and a 1e14 trial
            # value makes cubic interpolation pick alpha ~ f0/f1 ~ 1e-16 —
            # a zero step (cf. reference analysis.py:1917-1939, which also
            # tolerates failed evaluations rather than aborting). Fix:
            # sanitize non-finite values/gradients, and SQUASH blowup values
            # above a generous multiple of the starting objective through a
            # smooth monotone log so backtracking interpolation picks a
            # workable step. The squash is differentiable, so the returned
            # gradient is rescaled by its derivative and the (f, g) pair
            # stays consistent in the squashed region (an inconsistent pair
            # would misdirect L-BFGS-B/SLSQP line-search interpolation).
            # Below the cap the objective is untouched, so user-supplied
            # ftol/gtol keep their documented meaning near the solution.
            cap = [None]  # set from the first (x0) evaluation

            def fun(x):
                nonlocal counter
                counter += 1
                val, grad = _read(vg(np.asarray(x)))
                if not np.isfinite(val):
                    val = np.inf
                if not np.all(np.isfinite(grad)):
                    grad = np.where(np.isfinite(grad), grad, 0.0)
                if cap[0] is None and np.isfinite(val):
                    cap[0] = 1e4 * (abs(val) + 1.0)
                if cap[0] is not None and val > cap[0]:
                    # smooth squash: f -> cap + cap*log1p((f-cap)/cap),
                    # with matching chain-rule gradient scale so the
                    # optimizer sees a consistent (f, g) pair
                    excess = val - cap[0]
                    dsquash = 1.0 / (1.0 + excess / cap[0])
                    val = cap[0] + cap[0] * np.log1p(excess / cap[0])
                    if np.isfinite(val):
                        grad = grad * dsquash
                    else:  # val was +inf
                        val = np.finfo(np.float64).max / 1e10
                        grad = np.zeros_like(grad)
                fit_history.append([val] + list(np.asarray(x, dtype=float)))
                return val, grad

            if algo == "l-bfgs-b":
                options.setdefault("maxls", 50)
            jac = True
        else:
            def fun(x):
                val = self._minimizer_callable(
                    x, hypo_maker, data_dist, metric_name, counter, fit_history
                )
                if external_priors_penalty is not None:
                    sign = (
                        -1.0
                        if stats.is_metric_to_maximize(metric_name)
                        else 1.0
                    )
                    val = val + sign * external_priors_penalty(
                        hypo_maker, metric_name
                    )
                return val

            jac = None

        if algo in GLOBAL_SCIPY_METHODS:
            minimizer_kwargs = dict(
                method="l-bfgs-b", bounds=bounds, jac=jac
            )
            if algo == "basinhopping":
                take_step = BoundedRandomDisplacement(
                    stepsize=options.pop("stepsize", 0.5)
                )
                local_options = options.pop("minimizer_options", None)
                if local_options:
                    minimizer_kwargs["options"] = dict(local_options)
                opt_result = spo.basinhopping(
                    fun,
                    x0,
                    minimizer_kwargs=minimizer_kwargs,
                    take_step=take_step,
                    **options,
                )
            elif algo == "differential_evolution":
                # an NLopt-style total-evaluation budget (maxeval) becomes a
                # generation cap: each generation costs popsize*n_params
                # evaluations, and polishing (a numeric-gradient L-BFGS-B)
                # is skipped under tight budgets so the cap is honored
                maxeval_budget = options.pop("_maxeval_budget", None)
                polish = options.pop("polish", True)
                if maxeval_budget is not None:
                    popsize = int(options.get("popsize", 15))
                    per_gen = max(1, popsize * len(x0))
                    options["maxiter"] = max(
                        1, int(maxeval_budget) // per_gen
                    )
                    if int(maxeval_budget) < 10 * per_gen:
                        polish = False
                opt_result = spo.differential_evolution(
                    (lambda x: fun(x)[0]) if jac else fun,
                    bounds=bounds,
                    polish=polish,
                    **options,
                )
            elif algo == "dual_annealing":
                opt_result = spo.dual_annealing(
                    (lambda x: fun(x)[0]) if jac else fun,
                    bounds=bounds,
                    **options,
                )
            elif algo == "shgo":
                opt_result = spo.shgo(
                    (lambda x: fun(x)[0]) if jac else fun,
                    bounds=bounds,
                    **options,
                )
            elif algo == "direct":
                # scipy's DIRECT is the same algorithm as NLopt GN_DIRECT;
                # maxfun is a hard cap on objective evaluations
                opt_result = spo.direct(
                    (lambda x: fun(x)[0]) if jac else fun,
                    bounds=bounds,
                    **options,
                )
        else:
            kwargs = dict(
                method=algo, bounds=bounds, options=options
            )
            if constraints:
                kwargs["constraints"] = constraints
            if algo == "cobyla":
                # COBYLA ignores bounds pre-scipy 1.11; supply as constraints
                kwargs.pop("bounds", None)
                cons = list(constraints) if constraints else []
                for i in range(len(x0)):
                    cons.append(
                        {"type": "ineq", "fun": (lambda x, i=i: x[i])}
                    )
                    cons.append(
                        {"type": "ineq", "fun": (lambda x, i=i: 1.0 - x[i])}
                    )
                kwargs["constraints"] = cons
            if jac:
                kwargs["jac"] = True
            opt_result = spo.minimize(fun, x0, **kwargs)

        minimizer_time = time.time() - t_start

        # set best-fit params on the hypo maker (cf. reference :1947-1952)
        best_x = np.clip(np.asarray(opt_result.x, dtype=np.float64), 0, 1)
        hypo_maker._set_rescaled_free_params(best_x)

        if vg is not None:
            # report the exact objective at the solution (opt_result.fun
            # may be the capped value if the optimizer ended on a blowup)
            raw_val, _ = _read(vg(best_x))
            opt_result.fun = raw_val

        sign = -1.0 if stats.is_metric_to_maximize(metric_name) else +1.0
        metadata = {
            "success": bool(getattr(opt_result, "success", True)),
            "message": str(getattr(opt_result, "message", "")),
            "nit": int(getattr(opt_result, "nit", -1)),
            "nfev": int(getattr(opt_result, "nfev", -1)),
            "method": algo,
        }

        result = HypoFitResult(
            metric=metric,
            metric_val=sign * float(opt_result.fun),
            data_dist=data_dist,
            hypo_maker=hypo_maker,
            minimizer_time=minimizer_time,
            minimizer_metadata=metadata,
            fit_history=fit_history,
            counter=counter,
        )
        if not metadata["success"]:
            logging.warning(
                "Minimizer reported failure: %s", metadata["message"]
            )
        return result

    def _fit_gradient(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Pure compiled-path gradient fit (TPU-first)."""
        kwargs = dict(method_kwargs or {})
        kwargs.setdefault("method", "l-bfgs-b")
        kwargs["gradient"] = True
        return self._fit_scipy(
            data_dist, hypo_maker, metric, external_priors_penalty,
            kwargs, local_fit_kwargs,
        )

    def _fit_device(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """The whole L-BFGS loop with its state on the hypo maker's device
        (``analysis/device_fit.py``: optax's L-BFGS and zoom line search,
        one host read of a flag tensor per objective evaluation).
        method_kwargs: ``max_steps``, ``gtol`` and ``device``.

        The JAX package's ``platform`` routing (a toy-scale fit sent to the
        host backend) has no counterpart: a fit runs where its hypo maker
        lives, and ``device``, where given, must name that device (a fit on
        the CPU is a fit of ``DistributionMaker(..., device="cpu")``)."""
        from pisa_tpu_torch.analysis import device_fit

        if external_priors_penalty is not None:
            raise ValueError(
                "external (host-side) penalties cannot run inside the"
                " device loop; use method='gradient'"
            )
        kwargs = dict(method_kwargs or {})
        max_steps = int(kwargs.pop("max_steps", 200))
        gtol = kwargs.pop("gtol", None)  # None -> precision-aware default
        device = kwargs.pop("device", None)
        if "platform" in kwargs:
            raise ValueError(
                "the port has no platform routing: a fit runs on its hypo"
                " maker's device; build the hypo maker with"
                " device='cpu' to fit on the CPU"
            )
        if kwargs:
            raise ValueError(f"unknown device-fit options: {sorted(kwargs)}")
        metric_name = self._metric_name(metric)

        free = hypo_maker.params.free
        if len(free) == 0:
            return self._no_fit_result(
                data_dist, hypo_maker, metric, external_priors_penalty
            )
        t_start = time.time()
        compiled = self._get_compiled(hypo_maker)
        if device is not None and resolve_device(device) != compiled.device:
            raise ValueError(
                f"the hypo maker lives on {compiled.device}, the fit was"
                f" asked for on {device}; build the hypo maker with"
                f" device={str(device)!r}"
            )
        value_fn, _ = compiled.build_objective(
            self._data_total(data_dist), metric_name
        )
        x0 = np.asarray(free._rescaled_values, dtype=np.float64)
        los, his = compiled._current_bounds()
        res = device_fit.minimize_on_device(
            value_fn.raw, x0, los, his, max_steps=max_steps, gtol=gtol,
            device=compiled.device,
        )
        minimizer_time = time.time() - t_start

        hypo_maker._set_rescaled_free_params(np.clip(res["x"], 0.0, 1.0))
        sign = -1.0 if stats.is_metric_to_maximize(metric_name) else +1.0
        counter = Counter()
        counter += res["nfev"]
        return HypoFitResult(
            metric=metric,
            metric_val=sign * res["fun"],
            data_dist=data_dist,
            hypo_maker=hypo_maker,
            minimizer_time=minimizer_time,
            minimizer_metadata={
                "success": bool(np.isfinite(res["fun"])),
                "message": "",
                "nit": res["nit"],
                "nfev": res["nfev"],
                "reads": res["reads"],
                "method": "device_lbfgs",
            },
            fit_history=[["metric"] + list(free.names)],
            counter=counter,
        )

    def _fit_iminuit(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Migrad-style fit (cf. reference ``analysis.py:1999``).

        Where the real ``iminuit`` is importable, its route raises (ROADMAP
        queue 1, item 14); otherwise this runs the native equivalent: a gradient (L-BFGS-B) minimization followed by a
        **Hesse** step — parameter uncertainties from the inverse Hessian of
        the objective at the minimum. The Hessian comes from central finite
        differences of the *analytic* (autodiff) gradient of the compiled
        objective, so the errors are exact to O(h^2) where Migrad's are an
        iterative approximation. Errors land in
        ``minimizer_metadata['hesse_errors']`` (physical units per free
        param), alongside ``hesse_cov_rescaled`` in [0,1]-space.
        """
        kwargs = dict(method_kwargs or {})
        run_hesse = bool(kwargs.pop("run_hesse", True))
        tol = kwargs.pop("tol", None)

        try:
            import iminuit  # noqa: F401

            have_iminuit = True
        except ImportError:
            have_iminuit = False

        if have_iminuit:
            result = self._fit_iminuit_real(
                data_dist, hypo_maker, metric, external_priors_penalty,
                kwargs, tol,
            )
            return result

        fit_kwargs = {"method": "l-bfgs-b", "gradient": True}
        if tol is not None:
            fit_kwargs["options"] = {"ftol": float(tol)}
        fit_kwargs.update(kwargs)
        result = self._fit_scipy(
            data_dist, hypo_maker, metric, external_priors_penalty,
            fit_kwargs, local_fit_kwargs,
        )
        result.minimizer_metadata["method"] = "iminuit-equivalent (native)"

        if run_hesse and external_priors_penalty is None:
            try:
                self._attach_hesse_errors(result, hypo_maker, data_dist, metric)
            except Exception as exc:
                logging.warning("Hesse step failed: %s", exc)
        return result

    def _fit_iminuit_real(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        kwargs, tol,
    ):
        """Migrad and Hesse through the real ``iminuit`` package
        (``pisa_tpu/analysis/analysis.py:983``)."""
        raise NotImplementedError(f"the iminuit package route {_NOT_PORTED}")

    def _attach_hesse_errors(self, result, hypo_maker, data_dist, metric):
        """Hesse step: parameter errors from the inverse Hessian of the
        objective at the best fit, via central differences of the analytic
        gradient (the compiled objective's autodiff VJP)."""
        metric_name = self._metric_name(metric)
        compiled = self._get_compiled(hypo_maker)
        _, vg = compiled.build_objective(
            self._data_total(data_dist), metric_name
        )
        free = hypo_maker.params.free
        x = np.asarray(free._rescaled_values, dtype=np.float64)
        n = len(x)
        h = 1e-4
        hess = np.zeros((n, n))
        for i in range(n):
            xp = x.copy(); xp[i] = min(1.0, x[i] + h)
            xm = x.copy(); xm[i] = max(0.0, x[i] - h)
            _, gp = _read(vg(xp))
            _, gm = _read(vg(xm))
            hess[i] = (gp - gm) / (xp[i] - xm[i])
        hess = 0.5 * (hess + hess.T)
        # llh-family objectives are -llh; chi2-family are chi2 = -2llh.
        # cov = H^{-1} for -llh, 2 H^{-1} for chi2 (errordef 1 vs 2).
        errordef = 1.0 if stats.is_metric_to_maximize(metric_name) else 2.0
        cov = errordef * np.linalg.inv(hess)
        var = np.clip(np.diag(cov), 0.0, np.inf)
        # rescaled -> physical units via d(mag)/d(rescaled)
        errors = {}
        for i, p in enumerate(free):
            lo = p.range[0].m_as(p.units)
            hi = p.range[1].m_as(p.units)
            if p.scales_as_log:
                deriv = abs(
                    p.value.m_as(p.units) * np.log(abs(hi) / abs(lo))
                )
            else:
                deriv = hi - lo
            errors[p.name] = float(np.sqrt(var[i]) * abs(deriv))
        result.minimizer_metadata["hesse_errors"] = errors
        result.minimizer_metadata["hesse_cov_rescaled"] = cov.tolist()

    # NLopt algorithm -> native scipy equivalent, for the gradient names
    # (``pisa_tpu/analysis/analysis.py:1096``; reference ``analysis.py:2218``
    # has the same vocabulary)
    _NLOPT_EQUIV = {
        "LN_NELDERMEAD": ("nelder-mead", False),
        "LN_SBPLX": ("nelder-mead", False),
        "LN_COBYLA": ("cobyla", False),
        "LN_BOBYQA": ("powell", False),
        "LN_PRAXIS": ("powell", False),
        "LD_LBFGS": ("l-bfgs-b", True),
        "LD_SLSQP": ("slsqp", True),
        "LD_MMA": ("l-bfgs-b", True),
        "GN_DIRECT": ("direct", False),
        "GN_DIRECT_L": ("direct", False),
        "GN_CRS2_LM": ("differential_evolution", False),
        "GN_ESCH": ("differential_evolution", False),
        "GN_ISRES": ("differential_evolution", False),
        "G_MLSL": ("basinhopping", True),
        "G_MLSL_LDS": ("basinhopping", True),
        "GD_STOGO": ("basinhopping", True),
    }

    def _fit_nlopt(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """NLopt-style fit (cf. reference ``analysis.py:2218``).

        Uses the real ``nlopt`` when importable; otherwise translates the
        NLopt algorithm vocabulary (``method_kwargs['algorithm']`` e.g.
        'LN_NELDERMEAD', 'GN_CRS2_LM', …) and stopping criteria
        (ftol_abs/ftol_rel/xtol_rel/maxeval) to the equivalent native
        scipy/gradient fit.
        """
        kwargs = dict(method_kwargs or {})
        algo = str(kwargs.pop("algorithm", "LN_NELDERMEAD")).upper()
        algo = algo.replace("NLOPT_", "")

        # gradient-based NLopt names (LD_/GD_) always use the native
        # translation: the reference outright rejects them
        # (``analysis.py:2407-2409``), while the native scipy path runs
        # them with analytic (autodiff) gradients — strictly better.
        # Derivative-free names run the real nlopt schema
        # (`_fit_nlopt_real`) against the real package when installed or
        # the in-repo shim otherwise (see `_import_nlopt`).
        gradient_algo = len(algo) > 1 and algo.split("_")[0].endswith("D")
        if not gradient_algo:
            real_kwargs = dict(method_kwargs or {})
            real_kwargs["algorithm"] = algo
            return self._fit_nlopt_real(
                data_dist, hypo_maker, metric, external_priors_penalty,
                real_kwargs, local_fit_kwargs,
            )

        if algo not in self._NLOPT_EQUIV:
            raise ValueError(
                f"Unknown NLopt algorithm {algo!r}; known:"
                f" {sorted(self._NLOPT_EQUIV)}"
            )
        scipy_method, use_grad = self._NLOPT_EQUIV[algo]

        # translate NLopt stopping criteria to the TARGET's own vocabulary:
        # each scipy global optimizer takes different keyword names (shgo has
        # no maxiter; differential_evolution uses tol not ftol; basinhopping
        # counts hops via niter), and scipy.optimize.minimize option names
        # differ per local method
        maxeval = kwargs.pop("maxeval", None)
        ftol_abs = kwargs.pop("ftol_abs", None)
        ftol_rel = kwargs.pop("ftol_rel", None)
        xtol_rel = kwargs.pop("xtol_rel", None)
        kwargs.pop("xtol_abs", None)

        options = {}
        if scipy_method == "nelder-mead":
            if maxeval is not None:
                options["maxfev"] = int(maxeval)
            if ftol_abs is not None:
                options["fatol"] = float(ftol_abs)
            if xtol_rel is not None:
                options["xatol"] = float(xtol_rel)
        elif scipy_method == "cobyla":
            if maxeval is not None:
                options["maxiter"] = int(maxeval)
            tol = ftol_abs if ftol_abs is not None else ftol_rel
            if tol is not None:
                options["tol"] = float(tol)
        elif scipy_method == "powell":
            if maxeval is not None:
                options["maxfev"] = int(maxeval)
            if ftol_rel is not None or ftol_abs is not None:
                options["ftol"] = float(
                    ftol_rel if ftol_rel is not None else ftol_abs
                )
            if xtol_rel is not None:
                options["xtol"] = float(xtol_rel)
        elif scipy_method in ("l-bfgs-b", "slsqp"):
            if maxeval is not None:
                options["maxiter"] = int(maxeval)
            if ftol_abs is not None or ftol_rel is not None:
                options["ftol"] = float(
                    ftol_abs if ftol_abs is not None else ftol_rel
                )
            if scipy_method == "l-bfgs-b" and xtol_rel is not None:
                options["gtol"] = float(xtol_rel)
        elif scipy_method == "basinhopping":
            if maxeval is not None:
                # hops, each wrapping a full local fit; also cap each local
                # fit's iterations so the NLopt-style total budget holds
                options["niter"] = max(1, int(maxeval) // 20)
                options["minimizer_options"] = {
                    "maxiter": max(5, int(maxeval) // (options["niter"] + 1))
                }
        elif scipy_method == "differential_evolution":
            if maxeval is not None:
                # NLopt maxeval is a TOTAL evaluation budget; _fit_scipy
                # converts it to a generation cap (popsize*n_params per
                # generation) and disables polishing under tight budgets
                options["_maxeval_budget"] = int(maxeval)
            tol = ftol_rel if ftol_rel is not None else ftol_abs
            if tol is not None:
                options["tol"] = float(tol)
        elif scipy_method == "dual_annealing":
            if maxeval is not None:
                options["maxiter"] = int(maxeval)
        elif scipy_method == "shgo":
            inner = {}
            if maxeval is not None:
                inner["maxfev"] = int(maxeval)
            if ftol_abs is not None:
                inner["f_tol"] = float(ftol_abs)
            if inner:
                options["options"] = inner
        elif scipy_method == "direct":
            # same DIRECT algorithm in scipy: maxfun is a hard evaluation
            # cap (NLopt maxeval semantics); *_L variants are the
            # locally-biased flavor
            if maxeval is not None:
                options["maxfun"] = int(maxeval)
            options["locally_biased"] = algo.endswith("_L")
            tol = ftol_rel if ftol_rel is not None else ftol_abs
            if tol is not None:
                options["f_min_rtol"] = float(max(tol, 1e-12))

        fit_kwargs = {"method": scipy_method, "gradient": use_grad}
        if options:
            fit_kwargs["options"] = options
        fit_kwargs.update(kwargs)
        result = self._fit_scipy(
            data_dist, hypo_maker, metric, external_priors_penalty,
            fit_kwargs, local_fit_kwargs,
        )
        result.minimizer_metadata["method"] = (
            f"nlopt-equivalent (native, {algo} -> {scipy_method})"
        )
        return result

    #: nlopt result code -> message (cf. reference ``analysis.py:2354``)
    _NLOPT_MESSAGES = {
        1: "NLOPT_SUCCESS",
        2: "NLOPT_STOPVAL_REACHED",
        3: "NLOPT_FTOL_REACHED",
        4: "NLOPT_XTOL_REACHED",
        5: "NLOPT_MAXEVAL_REACHED",
        6: "NLOPT_MAXTIME_REACHED",
        -1: "NLOPT_FAILURE",
        -2: "NLOPT_INVALID_ARGS",
        -3: "NLOPT_OUT_OF_MEMORY",
        -4: "NLOPT_ROUNDOFF_LIMITED",
        -5: "NLOPT_FORCED_STOP",
    }

    def _define_nlopt_opt(self, method_kwargs, loss_func, n_free,
                          hypo_maker):
        """Build an ``nlopt.opt`` from a reference-schema options dict
        (cf. reference ``analysis.py:2398-2460``): stopping criteria,
        algorithm-specific params, inequality constraints (AUGLAG et al.),
        stochastic population, initial step, and a recursively-constructed
        ``local_optimizer`` (MLSL / AUGLAG subsidiary optimizers)."""
        nlopt = _import_nlopt()

        kwargs = dict(method_kwargs)
        algo = str(kwargs.get("algorithm", ""))
        name = algo.upper()
        if name.startswith("NLOPT_"):
            name = name[len("NLOPT_"):]
        if not name:
            raise ValueError("Need to specify the algorithm to use.")
        parts = name.split("_")
        if len(parts[0]) > 1 and parts[0][1] == "D":
            raise ValueError(
                "Only gradient-free NLopt algorithms (GN/LN/AUGLAG/MLSL)"
                " are supported; for gradient-based fits use the native"
                " 'gradient'/'device' methods, which use analytic"
                " (autodiff) gradients instead of NLopt's user-supplied"
                " ones"
            )
        try:
            algorithm = getattr(nlopt, name)
        except AttributeError:
            raise ValueError(f"Unknown NLopt algorithm {algo!r}")

        opt = nlopt.opt(algorithm, n_free)
        opt.set_min_objective(loss_func)

        if "ftol_abs" in kwargs:
            opt.set_ftol_abs(kwargs["ftol_abs"])
        if "ftol_rel" in kwargs:
            opt.set_ftol_rel(kwargs["ftol_rel"])
        if "xtol_abs" in kwargs:
            opt.set_xtol_abs(kwargs["xtol_abs"])
        if "xtol_rel" in kwargs:
            opt.set_xtol_rel(kwargs["xtol_rel"])
        if "stopval" in kwargs:
            opt.set_stopval(kwargs["stopval"])
        if "maxeval" in kwargs:
            opt.set_maxeval(int(kwargs["maxeval"]))
        if "maxtime" in kwargs:
            opt.set_maxtime(kwargs["maxtime"])
        for k, v in dict(kwargs.get("algorithm_params", {})).items():
            opt.set_param(k, v)
        if "ineq_constraints" in kwargs:
            for fn in self._nlopt_ineq_constraint_funcs(
                kwargs["ineq_constraints"], hypo_maker
            ):
                opt.add_inequality_constraint(fn)
        if "population" in kwargs:
            opt.set_population(int(kwargs["population"]))
        if "initial_step" in kwargs:
            opt.set_initial_step(kwargs["initial_step"])

        opt.set_lower_bounds(0.0)
        opt.set_upper_bounds(1.0)

        if "local_optimizer" in kwargs:
            opt.set_local_optimizer(
                self._define_nlopt_opt(
                    kwargs["local_optimizer"], loss_func, n_free, hypo_maker
                )
            )
        return opt

    def _nlopt_ineq_constraint_funcs(self, exprs, hypo_maker):
        """NLopt-signature ``f(x, grad) >= 0 -> f <= 0`` constraint
        callables from expression strings over the (physical-valued)
        ParamSet (cf. reference
        ``configure_nlopt_minimization.py``). NLopt requires f(x) <= 0
        feasible; expressions are written scipy-style (>= 0 feasible) in
        the repo's constrained-fit dialect, so the sign is flipped here."""
        if isinstance(exprs, str):
            exprs = [exprs]
        funcs = []
        for expr in exprs:
            compiled = compile(str(expr), "<ineq_constraint>", "eval")

            def fn(x, grad, _c=compiled, _hm=hypo_maker):
                if grad.size > 0:
                    raise RuntimeError(
                        "inequality constraints are derivative-free"
                    )
                _hm._set_rescaled_free_params(np.asarray(x, float))
                val = eval(  # noqa: S307 - reference-compatible config eval
                    _c, {"np": np}, {"params": _hm.params}
                )
                return -float(val)

            funcs.append(fn)
        return funcs

    def _fit_nlopt_real(
        self, data_dist, hypo_maker, metric, external_priors_penalty,
        method_kwargs, local_fit_kwargs,
    ):
        """Fit with the ``nlopt`` API — the real package when installed,
        the in-repo scipy-backed shim otherwise — over [0,1]-rescaled free
        params (cf. reference ``analysis.py:2218-2470``). Supports every
        derivative-free NLopt algorithm, AUGLAG inequality constraints and
        MLSL/AUGLAG subsidiary local optimizers via
        ``method_kwargs['local_optimizer']``."""
        nlopt = _import_nlopt()

        if local_fit_kwargs is not None:
            logging.warning(
                "`local_fit_kwargs` are ignored by nlopt fits; use"
                " method_kwargs['local_optimizer'] for subsidiary"
                " optimizers"
            )
        metric_name = self._metric_name(metric)
        free = hypo_maker.params.free
        if len(free) == 0:
            return self._no_fit_result(
                data_dist, hypo_maker, metric, external_priors_penalty
            )
        x0 = np.asarray(free._rescaled_values, dtype=np.float64)
        counter = Counter()
        fit_history = [["metric"] + list(free.names)]

        sign = -1.0 if stats.is_metric_to_maximize(metric_name) else +1.0

        def loss_func(x, grad):
            if np.any(~np.isfinite(x)):
                logging.warning(
                    "NLopt evaluated at non-finite parameters: %s", x
                )
                return np.nan
            if grad.size > 0:
                raise RuntimeError(
                    "NLopt gradient request on a derivative-free fit;"
                    " use the native 'gradient' method for analytic"
                    " gradients"
                )
            val = self._minimizer_callable(
                x, hypo_maker, data_dist, metric_name, counter, fit_history
            )
            if external_priors_penalty is not None:
                val = val + sign * external_priors_penalty(
                    hypo_maker, metric_name
                )
            return float(val)

        if "seed" in method_kwargs:
            nlopt.srand(int(method_kwargs.pop("seed")))

        opt = self._define_nlopt_opt(
            method_kwargs, loss_func, len(x0), hypo_maker
        )

        t_start = time.time()
        try:
            xopt = opt.optimize(x0)
            nlopt_result = opt.last_optimize_result()
            fun = float(opt.last_optimum_value())
        except Exception as exc:  # optimizer failure -> +/-inf result
            logging.warning("NLopt fit failed: %s", exc)
            xopt = x0
            nlopt_result = -1
            fun = np.inf
        minimizer_time = time.time() - t_start

        best_x = np.clip(np.asarray(xopt, dtype=np.float64), 0.0, 1.0)
        hypo_maker._set_rescaled_free_params(best_x)

        metadata = {
            "success": nlopt_result > 0,
            "nlopt_result": int(nlopt_result),
            "message": self._NLOPT_MESSAGES.get(
                int(nlopt_result), str(nlopt_result)
            ),
            "nit": int(opt.get_numevals()),
            "nfev": int(opt.get_numevals()),
            "method": f"nlopt:{opt.get_algorithm_name()}",
        }
        result = HypoFitResult(
            metric=metric,
            metric_val=sign * fun,
            data_dist=data_dist,
            hypo_maker=hypo_maker,
            minimizer_time=minimizer_time,
            minimizer_metadata=metadata,
            fit_history=fit_history,
            counter=counter,
        )
        if not metadata["success"]:
            logging.warning(
                "NLopt reported failure: %s", metadata["message"]
            )
        return result

class Analysis(BasicAnalysis):
    """Convenience interface mirroring the reference ``Analysis``."""

    def fit_hypo(
        self,
        data_dist,
        hypo_maker,
        metric,
        minimizer_settings=None,
        hypo_param_selections=None,
        reset_free=True,
        **kwargs,
    ):
        if hypo_param_selections:
            hypo_maker.select_params(hypo_param_selections)
        if reset_free:
            hypo_maker.reset_free()
        if isinstance(minimizer_settings, str) or (
            isinstance(minimizer_settings, dict)
            and isinstance(minimizer_settings.get("method"), dict)
        ):
            # reference settings-file schema (settings/minimizer/*.json):
            # validated + defaulted, then run through the scipy path
            from pisa_tpu_torch.analysis.minimizer_config import (
                load_minimizer_settings,
            )

            minimizer_settings = {
                "method": "scipy",
                "method_kwargs": load_minimizer_settings(minimizer_settings),
            }
        settings = minimizer_settings or {
            "method": "scipy",
            "method_kwargs": {"method": "l-bfgs-b"},
        }
        result = self.fit_recursively(
            data_dist,
            hypo_maker,
            metric,
            None,
            settings.get("method", "scipy"),
            settings.get("method_kwargs"),
            settings.get("local_fit_kwargs"),
        )
        return result, None

    def profile(
        self, data_dist, hypo_maker, param_name, values, metric, **fit_kwargs
    ):
        """1-d profile scan: fix `param_name` at each value, fit the rest."""
        param = hypo_maker.params[param_name]
        orig_fixed = param.is_fixed
        results = []
        for v in values:
            param.value = v
            param.is_fixed = True
            result = self.fit_recursively(
                data_dist, hypo_maker, metric, None,
                fit_kwargs.get("method", "scipy"),
                fit_kwargs.get("method_kwargs"),
                fit_kwargs.get("local_fit_kwargs"),
            )
            results.append(result)
        param.is_fixed = orig_fixed
        return results
