"""
A pipeline as one differentiable function of its free parameters.

Counterpart of ``pisa_tpu/core/template.py``: ``Pipeline.compile()``
returns a :class:`CompiledTemplate`, a function

    rescaled free params (vector in [0, 1]^n) -> {category: flat binned hist}

whose gradient (and the fit metric's) comes from autograd, with the
oscillation stage's gradient running the CUDA tangent kernels
(``ops/osc/chain.py:osc_probs``). It replaces the reference's
finite-difference gradients (~2n templates per step, ``analysis.py:1561``).

Mechanics, as in the JAX package: the free params' magnitudes are set on the
shared Param objects as 0-d float64 tensors on the host that carry the
autograd graph (wrapped in unit-tagged Quantities, so stage code is
unchanged); the stages' compute caches are bypassed (template mode); the
leading stages with no free parameter run once here, and every evaluation
starts from the container state they left, then restores the state it found,
so the eager ``get_outputs()`` path is unaffected.

There is no ``jit``: the stages run eagerly in torch. The JAX package's
category stacking, rate deferral (``core/stacking.py``,
``template.py:185-282``), sharding and ``scan_totals`` are not ported
(ROADMAP queue 1, item 6); the template runs per container, as the JAX one
does with ``PISA_TPU_STACK=0``.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.units import Quantity

__all__ = ["CompiledTemplate", "HOST_PARAM_NAMES"]

#: params that steer host-side precomputation and hence cannot be
#: differentiated (``pisa_tpu/core/template.py:42-56``); stages add theirs
#: through ``host_param_names``
HOST_PARAM_NAMES = {
    "earth_model",
    "detector_depth",
    "prop_height",
    "YeI",
    "YeO",
    "YeM",
    "density_scale",
    "core_density_scale",
    "innermantle_density_scale",
    "middlemantle_density_scale",
    "n_events",
    "seed",
    "random",
}


class CompiledTemplate:
    """``rescaled free params -> histograms`` for a Pipeline.

    Parameters
    ----------
    pipeline : Pipeline
    output_binning : MultiDimBinning
    output_key : str or (key, error_key)

    The vector is in the *rescaled* [0, 1] space of minimizers (reference
    ``param.py:358``); the conversion to physical magnitudes happens inside,
    so gradients are with respect to the rescaled values.
    """

    def __init__(self, pipeline, output_binning, output_key):
        self.pipeline = pipeline
        self.output_binning = output_binning
        if isinstance(output_key, (tuple, list)):
            self.output_key, self.error_key = output_key[0], output_key[1]
        else:
            self.output_key, self.error_key = output_key, None

        host_params = set(HOST_PARAM_NAMES)
        for stage in pipeline.stages:
            host_params.update(stage.host_param_names)
        free = pipeline.params.free
        for p in free:
            if p.name in host_params:
                raise ValueError(
                    f"Free param {p.name!r} steers host-side precomputation"
                    " and cannot be part of a compiled template; fix it or"
                    " use the eager path"
                )
        self.free_names = list(free.names)
        self._free_params = list(free)
        self._log_scaled = [p.scales_as_log for p in self._free_params]
        self.names = list(pipeline.data.names)

        # The leading stages with no free parameter run once, here; every
        # evaluation starts from the container state they leave.
        self._hoisted_stages, self._traced_stages = self._split_stages()
        for stage in self._hoisted_stages:
            stage.run()
        self._base_state = pipeline.data.state()

    def _split_stages(self):
        """(hoisted, traced): the longest leading run of stages none of
        whose params is free, directly or through a DerivedParam dependency
        (``pisa_tpu/core/template.py:140``). Only a prefix is safe: a stage
        without free params downstream of a traced one (e.g. utils.hist)
        consumes per-template values."""

        def expand(p):
            yield p
            for dep in getattr(p, "dependson", {}).values():
                yield from expand(dep)

        free_ids = {id(p) for p in self._free_params}
        stages = list(self.pipeline.stages)
        n_hoisted = 0
        for stage in stages:
            if any(id(q) in free_ids for p in stage.params for q in expand(p)):
                break
            n_hoisted += 1
        return stages[:n_hoisted], stages[n_hoisted:]

    # -- parameters ------------------------------------------------------------
    def _current_bounds(self):
        """The free params' live range bounds (magnitudes in their units):
        runtime inputs, so range changes need no new template."""
        los = [float(p.range[0].m_as(p.units)) for p in self._free_params]
        his = [float(p.range[1].m_as(p.units)) for p in self._free_params]
        return np.asarray(los), np.asarray(his)

    def _magnitudes_from_rescaled(self, vec, los=None, his=None):
        """Physical magnitudes (0-d float64 host tensors, differentiable in
        `vec`) of the rescaled vector, log-aware as ``Param._rescaled_value``
        (``pisa_tpu/core/template.py:364``)."""
        if los is None or his is None:
            los, his = self._current_bounds()
        vec = torch.as_tensor(vec).to(device="cpu", dtype=torch.float64)
        mags = []
        for i, log_scale in enumerate(self._log_scaled):
            lo, hi = float(los[i]), float(his[i])
            if log_scale:
                mags.append(torch.exp(
                    vec[i] * (np.log(abs(hi)) - np.log(abs(lo)))) * lo)
            else:
                mags.append(lo + (hi - lo) * vec[i])
        return mags

    def current_rescaled_values(self):
        return np.asarray(
            [float(p._rescaled_value) for p in self._free_params],
            dtype=np.float64,
        )

    # -- evaluation ---------------------------------------------------------------
    def _evaluate(self, vec, los=None, his=None):
        """Run the traced stages at `vec` from the hoisted state; returns
        ``{"hist": {name: flat tensor}}`` (and ``"error"``) on the pipeline's
        device, with the autograd graph back to `vec`."""
        pipeline = self.pipeline
        data = pipeline.data
        mags = self._magnitudes_from_rescaled(vec, los, his)
        saved_state = data.state()
        saved_values = [p._value for p in self._free_params]
        for stage in pipeline.stages:
            stage._template_mode = True
        try:
            data.set_state(self._base_state)
            for p, mag in zip(self._free_params, mags):
                p._value = Quantity(mag, p.units)
            for stage in self._traced_stages:
                stage.run()
            data.representation = self.output_binning
            out = {"hist": {c.name: c[self.output_key].reshape(-1)
                            for c in data.containers}}
            if self.error_key is not None:
                out["error"] = {c.name: c[self.error_key].reshape(-1)
                                for c in data.containers}
            return out
        finally:
            for p, value in zip(self._free_params, saved_values):
                p._value = value
            for stage in pipeline.stages:
                stage._template_mode = False
            data.set_state(saved_state)

    def __call__(self, rescaled_vector):
        """Raw evaluation: dict with 'hist' (and 'error') name -> flat
        tensor on the pipeline's device."""
        los, his = self._current_bounds()
        return self._evaluate(rescaled_vector, los, his)

    def get_outputs(self, rescaled_vector=None) -> MapSet:
        """Host-side MapSet in the pipeline's container order (mirrors
        ``Pipeline.get_outputs``); the current values by default."""
        if rescaled_vector is None:
            rescaled_vector = self.current_rescaled_values()
        with torch.no_grad():
            out = self(rescaled_vector)
        maps = []
        for name in self.names:
            err = out.get("error", {}).get(name)
            maps.append(Map(
                name=name,
                hist=out["hist"][name].cpu().numpy(),
                binning=self.output_binning,
                error_hist=None if err is None else err.cpu().numpy(),
            ))
        return MapSet(maps, name=self.pipeline.name)

    # -- objectives ---------------------------------------------------------------
    def build_objective(self, data_dist, metric, priors=True):
        """Functions ``value_only(vec)`` and ``value_and_grad(vec) ->
        (value, grad)`` of the rescaled vector for fitting `data_dist`
        (MapSet, Map, or dict name -> array) under `metric`
        (``pisa_tpu/core/template.py:630-751``).

        As in the reference's minimizer convention (``analysis.py:2493``):
        the metric summed over maps plus the prior penalties, sign-flipped
        for llh-family metrics so that it is always minimized.
        ``value_only.raw`` is the objective ``(vec, los, his) -> value`` with
        the bounds as arguments, for :func:`pisa_tpu_torch.analysis.
        device_fit.minimize_on_device`."""
        from pisa_tpu_torch.utils import stats

        maximize = stats.is_metric_to_maximize(metric)
        metric_fn = stats.metric_function(metric)
        if priors and (
            any(p.name.startswith("daemon_") for p in self._free_params)
            or any(s.service_name == "daemon_flux"
                   for s in self.pipeline.stages)
        ):
            raise NotImplementedError(
                "the daemonflux correlated prior penalty is not ported yet"
                " (ROADMAP queue 1, item 10)"
            )

        device = self.pipeline.device
        if isinstance(data_dist, MapSet):
            items = [(m.name, m.hist) for m in data_dist]
        elif isinstance(data_dist, Map):
            items = [(data_dist.name, data_dist.hist)]
        else:
            items = list(data_dist.items())
        data = {
            name: torch.as_tensor(np.array(h, dtype=np.float64).ravel(),
                                  dtype=TORCH_FTYPE, device=device)
            for name, h in items
        }
        sign = 1.0 if maximize else -2.0  # llh, or chi2 = -2 llh

        def objective(vec, los=None, his=None):
            hists = self._evaluate(vec, los, his)["hist"]
            total = sum(metric_fn(d, hists[name]).sum()
                        for name, d in data.items())
            if priors:
                mags = self._magnitudes_from_rescaled(vec, los, his)
                for p, mag in zip(self._free_params, mags):
                    if p.prior is None:
                        continue
                    if p.prior.units is not None:
                        mag = Quantity(mag, p.units).m_as(p.prior.units)
                    total = total + sign * p.prior.llh_torch(mag)
            return -total if maximize else total

        objective.device = device

        def value_only(vec):
            los, his = self._current_bounds()
            with torch.no_grad():
                return objective(vec, los, his)

        def value_and_grad(vec):
            los, his = self._current_bounds()
            vec = torch.as_tensor(vec, dtype=torch.float64)
            vec = vec.detach().clone().requires_grad_(True)
            value = objective(vec, los, his)
            (grad,) = torch.autograd.grad(value, vec)
            return value.detach(), grad

        value_only.raw = objective
        return value_only, value_and_grad
