"""
Compiled multi-pipeline objectives with analytic gradients.

Counterpart of ``pisa_tpu/analysis/gradient.py``: for a DistributionMaker
(or a lone Pipeline), one function

    rescaled free params -> scalar objective (and its gradient)

that runs each pipeline's compiled template
(:class:`pisa_tpu_torch.core.template.CompiledTemplate`), sums the
histograms of every map of every pipeline, applies the metric against the
data distribution and adds the prior penalties. Its gradient comes from
autograd, through the oscillation kernels' tangents, in place of the
reference's finite differences (~2n templates a step).

On a CUDA device the summed objective is captured as **one**
:class:`~pisa_tpu_torch.core.template.CapturedObjective` over all
pipelines (value and ``value_and_grad``), and the summed template as one
:class:`~pisa_tpu_torch.core.template.CapturedFunction`; neither is built
from the per-template graphs. Where the JAX package passes the containers'
data into its jitted objective as an argument (``_all_data_vals``), the
port's graphs read the data tensors by address, where they lay at capture,
and keep them alive; so ``value_fn.raw`` takes ``(vec, los, his)`` only.
On the CPU the same functions run eagerly.

``value_fn.raw_with_data`` (``pisa_tpu/analysis/gradient.py:316-318``) is
the batched form for the batched fits (``analysis/device_fit.py``):
``(vec (B, n), los, his, data (B, bins) or None) -> (B,)`` values, B
independent lanes in one program (``core/template.py``), differentiable in
`vec`; ``None`` compares every lane with the closed-over data. On a CUDA
device it is captured once per (B, with or without data), the data batch a
static input of the program that a call copies in;
``raw_with_data.bind(data, B)`` copies it in once and returns ``(vec, los,
his) -> (B,)`` for all the evaluations of a fit.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.core.template import (
    CapturedFunction,
    magnitudes_from_rescaled,
    on_device,
    wrap_objective,
)
from pisa_tpu_torch.units import Quantity
from pisa_tpu_torch.utils import stats
from pisa_tpu_torch.utils.daemonflux_native import compiled_daemon_penalty

__all__ = ["CompiledDistribution", "CompiledDetectors"]

#: metrics that take the data's variance (``gradient.py:236-244`` of the
#: JAX package)
_USES_VARIANCE = ("mod_chi2", "correct_chi2", "mcllh_mean", "mcllh_eff",
                  "barlow_llh", "conv_llh", "signed_sqrt_mod_chi2")


class _FreeParams:
    """The free params of a hypo maker, their live bounds (runtime inputs:
    octant and range changes need no new program) and rescaled values."""

    def _init_free(self, params, device):
        free = params.free
        self.free_names = list(free.names)
        self._free_params = list(free)
        self._log_scaled = [p.scales_as_log for p in self._free_params]
        self.device = device
        self._bounds_cache = None

    def _current_bounds(self):
        los = [float(p.range[0].m_as(p.units)) for p in self._free_params]
        his = [float(p.range[1].m_as(p.units)) for p in self._free_params]
        return np.asarray(los), np.asarray(his)

    def _device_bounds(self):
        """:meth:`_current_bounds` as float64 tensors on the device,
        uploaded again only when a range has changed."""
        los, his = self._current_bounds()
        cached = self._bounds_cache
        if cached is None or not (np.array_equal(los, cached[0])
                                  and np.array_equal(his, cached[1])):
            cached = self._bounds_cache = (los, his) + tuple(
                torch.as_tensor(b, device=self.device) for b in (los, his))
        return cached[2:]

    def current_rescaled_values(self):
        return np.asarray(
            [float(p._rescaled_value) for p in self._free_params],
            dtype=np.float64,
        )

    def set_rescaled_values(self, vec):
        for p, v in zip(self._free_params, np.asarray(vec)):
            p._rescaled_value = float(np.clip(v, 0.0, 1.0))

    def _daemon_penalty(self, priors):
        """The daemonflux switch of the hypo maker's pipelines
        (``compiled_daemon_penalty``), or None: built with the objective, so
        that fixed daemon params enter with their values then."""
        if not priors:
            return None
        return compiled_daemon_penalty(self._free_params, self._pipelines())

    def _prior_penalty(self, vec, los, his, maximize, daemon=None):
        """The free params' prior penalties in the metric's family (llh, or
        chi2 = -2 llh), from the magnitudes of `vec` (``gradient.py:261-287``
        of the JAX package); one per lane for a (B, n) `vec`. With `daemon`
        (:meth:`_daemon_penalty`) the free daemon_* params' priors give way
        to their one correlated chi2 (``gradient.py:224-287``)."""
        mags = magnitudes_from_rescaled(vec, los, his, self._log_scaled)
        lead = tuple(vec.shape[:-1])
        skip = daemon[0] if daemon is not None else frozenset()
        penalty = 0.0
        for i, (p, mag) in enumerate(zip(self._free_params, mags)):
            if p.prior is None or i in skip:
                continue
            if p.prior.units is not None:
                mag = mag * Quantity(1.0, p.units).m_as(p.prior.units)
            penalty = penalty + p.prior.llh_torch(mag).reshape(lead) * (
                1.0 if maximize else -2.0)
        if daemon is not None:
            penalty = penalty + daemon[1](mags).reshape(lead) * (
                1.0 if maximize else -2.0)
        return penalty


def _data_key(data_dists):
    """The content of the data distributions as a hashable key (bytes,
    collision-proof), or None where it cannot be read."""
    try:
        parts = []
        for m in data_dists:
            if isinstance(m, Map):
                parts.append(m.hist.tobytes())
                parts.append(None if m.variance is None
                             else m.variance.tobytes())
            else:
                parts.append(np.asarray(m).tobytes())
        return tuple(parts)
    except (AttributeError, TypeError, ValueError):  # not cached
        return None


class CompiledDistribution(_FreeParams):
    """Summed-template evaluation and objectives for a hypo maker.

    Parameters
    ----------
    hypo_maker : DistributionMaker or Pipeline
    capture : bool or None
        Capture the summed template and each objective in CUDA graphs (by
        default: on a CUDA device); ``False`` keeps the eager route.
    """

    def __init__(self, hypo_maker, capture=None):
        pipelines = ([hypo_maker] if isinstance(hypo_maker, Pipeline)
                     else list(hypo_maker.pipelines))
        self.hypo_maker = hypo_maker
        self._params = hypo_maker.params
        device = pipelines[0].device
        if any(p.device != device for p in pipelines):
            raise ValueError("the pipelines live on different devices")
        self._init_free(self._params, device)
        if capture is None:
            capture = device.type == "cuda"
        self.capture = bool(capture)

        # the templates run eagerly inside this object's programs; their
        # own captured calls serve get_outputs(return_sum=False) only
        self.templates = []
        self.index_maps = []
        self._index_tensors = []
        for p in pipelines:
            ct = p.compile(output_binning=p.output_binning,
                           output_key=p.output_key)
            self.templates.append(ct)
            idx = np.asarray([self.free_names.index(n)
                              for n in ct.free_names], dtype=np.int64)
            self.index_maps.append(idx)
            self._index_tensors.append(torch.as_tensor(idx, device=device))
        self._sum_program = None
        self._objective_cache = {}

    def _pipelines(self):
        return [ct.pipeline for ct in self.templates]

    # -- the summed template ----------------------------------------------------
    def _sum_fn(self, vec, los, his):
        """The summed histogram (flat) of every map of every pipeline; (B,
        bins) for a (B, n) `vec` of lanes."""
        lanes = vec.shape[0] if vec.dim() == 2 else None
        total = None
        for ct, idx in zip(self.templates, self._index_tensors):
            sub = vec.index_select(-1, idx)
            sub_lo, sub_hi = (x.index_select(0, idx) for x in (los, his))
            hist, _, _ = ct._stack_outputs(ct._evaluate(
                ct._magnitudes_from_rescaled(sub, sub_lo, sub_hi), lanes))
            s = hist.sum(-2)
            total = s if total is None else total + s
        return total

    def sum_hist(self, vec=None):
        """The summed template at `vec` (the current values by default) as
        a flat host array (``gradient.py:117``)."""
        if vec is None:
            vec = self.current_rescaled_values()
        los, his = self._device_bounds()
        if self.capture:
            if self._sum_program is None:
                self._sum_program = CapturedFunction(
                    lambda v, lo, hi: (self._sum_fn(v, lo, hi),),
                    self.current_rescaled_values(), los, his,
                    device=self.device)
            (hist,) = self._sum_program(vec, los, his)
        else:
            with torch.no_grad():
                hist = self._sum_fn(on_device(vec, self.device), los, his)
        return hist.cpu().numpy()

    def get_outputs(self, vec=None, return_sum=True):
        """A MapSet of the summed template, or a list with each pipeline's
        MapSet."""
        if vec is None:
            vec = self.current_rescaled_values()
        if return_sum:
            return MapSet([Map(
                name=getattr(self.hypo_maker, "label", None) or "total",
                hist=self.sum_hist(vec),
                binning=self.templates[0].output_binning,
            )], name="total")
        return [ct.get_outputs(np.asarray(vec)[idx])
                for ct, idx in zip(self.templates, self.index_maps)]

    # -- objective ---------------------------------------------------------------
    def build_objective(self, data_dist, metric, priors=True,
                        data_variance=None):
        """``(value_fn, vg_fn)`` of the rescaled vector: every pipeline's
        maps summed into one template and compared with `data_dist` (a
        MapSet, whose maps are summed, a Map, or an array) under `metric`,
        always minimized (llh-family negated, ``analysis.py:2493`` of the
        reference). Memoized on (metric, priors, the data's content), so
        repeated fits against the same data (octant, range and staged
        strategies) reuse the captured program."""
        dists = data_dist if isinstance(data_dist, MapSet) else [data_dist]
        key = _data_key(list(dists))
        if key is not None:
            key = (metric, bool(priors), key,
                   None if data_variance is None
                   else np.asarray(data_variance).tobytes())
            if key in self._objective_cache:
                return self._objective_cache[key]
        result = wrap_objective(
            self, self._objective(data_dist, metric, priors, data_variance),
            self.capture)
        if key is not None:
            self._objective_cache[key] = result
        return result

    def _objective(self, data_dist, metric, priors=True, data_variance=None):
        """The eager objective ``(vec, los, his) -> value``."""
        maximize = stats.is_metric_to_maximize(metric)
        metric_fn = stats.metric_function(metric)
        if isinstance(data_dist, MapSet):
            data = var = None
            for m in data_dist:
                data = m.hist.ravel() if data is None else data + m.hist.ravel()
                if m.variance is not None:
                    v = m.variance.ravel()
                    var = v if var is None else var + v
        elif isinstance(data_dist, Map):
            data = data_dist.hist.ravel()
            var = (None if data_dist.variance is None
                   else data_dist.variance.ravel())
        else:
            data, var = np.asarray(data_dist).ravel(), None
        if data_variance is not None:
            var = np.asarray(data_variance).ravel()

        def upload(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                   dtype=TORCH_FTYPE, device=self.device)

        data = upload(data)
        var = upload(var if var is not None else np.zeros(data.shape))
        uses_variance = metric in _USES_VARIANCE
        daemon = self._daemon_penalty(priors)

        def objective(vec, los, his, data_arg=None):
            # `data_arg`: the observed histograms as a program input, one
            # per lane (the batched fits); the closed-over variance stays
            exp = self._sum_fn(vec, los, his)
            d = data if data_arg is None else data_arg
            vals = (metric_fn(d, exp, var) if uses_variance
                    else metric_fn(d, exp))
            total = vals.sum(-1)
            if priors:
                total = total + self._prior_penalty(vec, los, his, maximize,
                                                    daemon)
            return -total if maximize else total

        return objective


class CompiledDetectors(_FreeParams):
    """The joint objective over several detectors (reference
    ``analysis.py:2591-2601``): one :class:`CompiledDistribution` per
    detector, composed into one differentiable function of the joint free
    vector (shared params fan out by index; suffixed detector-private
    params route to their detector), captured on a CUDA device as one
    program over all detectors."""

    def __init__(self, detectors, capture=None):
        self.hypo_maker = detectors
        self._cds = [CompiledDistribution(dm, capture=capture)
                     for dm in detectors.distribution_makers]
        device = self._cds[0].device
        if any(cd.device != device for cd in self._cds):
            raise ValueError("the detectors live on different devices")
        self._init_free(detectors.params, device)
        self.capture = self._cds[0].capture

        self.index_maps = []
        for dm, det_name in zip(detectors.distribution_makers,
                                detectors.det_names):
            idxs = []
            for n in dm.params.free.names:
                # a detector-private name collision is suffixed in the joint
                # set; the suffixed slot wins, so that a later detector's
                # param does not alias the first detector's bare one
                if f"{n}_{det_name}" in self.free_names:
                    idxs.append(self.free_names.index(f"{n}_{det_name}"))
                elif n in self.free_names:
                    idxs.append(self.free_names.index(n))
                else:
                    raise ValueError(
                        f"cannot locate {n!r} of detector {det_name!r} in"
                        " the joint free params"
                    )
            self.index_maps.append(np.asarray(idxs, dtype=np.int64))
        self._index_tensors = [torch.as_tensor(i, device=device)
                               for i in self.index_maps]
        self._objective_cache = {}

    def _pipelines(self):
        return [p for cd in self._cds for p in cd._pipelines()]

    def build_objective(self, data_dists, metric, priors=True):
        """``(value_fn, vg_fn)`` of the joint rescaled vector; `data_dists`
        is the per-detector list of data distributions. Memoized as
        :meth:`CompiledDistribution.build_objective`."""
        if not isinstance(data_dists, (list, tuple)):
            raise ValueError(
                "Detectors objectives need a per-detector list of data"
                " distributions"
            )
        flat = [m for ds in data_dists
                for m in (ds if isinstance(ds, MapSet) else [ds])]
        key = _data_key(flat)
        if key is not None:
            key = (metric, bool(priors), len(data_dists), key)
            if key in self._objective_cache:
                return self._objective_cache[key]
        maximize = stats.is_metric_to_maximize(metric)
        # per-detector objectives without priors; the joint priors below
        # count each shared param once
        objectives = [cd._objective(data, metric, priors=False)
                      for cd, data in zip(self._cds, data_dists)]
        daemon = self._daemon_penalty(priors)

        def objective(vec, los, his):
            total = 0.0
            for obj, idx in zip(objectives, self._index_tensors):
                total = total + obj(*(x.index_select(0, idx)
                                      for x in (vec, los, his)))
            if priors:
                penalty = self._prior_penalty(vec, los, his, maximize, daemon)
                # the detectors' objectives are already sign-flipped
                total = total + (-penalty if maximize else penalty)
            return total

        result = wrap_objective(self, objective, self.capture)
        if key is not None:
            self._objective_cache[key] = result
        return result
