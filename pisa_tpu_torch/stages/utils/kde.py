"""
KDE-smoothed mapping of events into binned space (counterpart of
``pisa_tpu/stages/utils/kde.py``; reference ``pisa/stages/utils/kde.py:18``):
the histogram replaced by an adaptive Gaussian KDE evaluated at the bin
centres, with coszen-edge reflection, log dimensions made linear, per-PID
stacking, stashed histograms and bootstrap errors.

The density runs on the ``kde_gauss_sum`` / ``kde_gauss_sum_vjp`` kernel
pair (``ops/kde.py``, through ``utils/kde.py:KDEPlan``). On a
category-stacked container (a compiled template, ``core/stacking.py``) every
category's PID channels form one batch: one launch for the pilots of all
(categories x channels), one for the densities at the bin centres, and one
each for their vector-Jacobian products in the backward pass. The padding
slots of the stacked layout carry zero weights (and NaN coordinates, which
the KDE makes finite), so they drop out of every statistic; the plan also
takes the container's ``real_events`` mask, so that neither they nor
another channel's samples are visited by the kernels (each channel's live
samples first, ``utils/kde.py:KDEPlan.live_order``). In an evaluation of
lanes the lane axis joins that batch.

Bootstrap errors resample on the host with ``np.random.default_rng(seed)``
(as the JAX stage does) and run per container, as do stashed histograms;
inside a compiled template (template mode, a CUDA-graph capture, or weights
that carry a gradient) ``stash_hists`` and ``bootstrap`` refuse, as the JAX
stage refuses (or fails) under tracing.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.kde import KDEPlan, traced

__all__ = ["kde", "init_test"]


class kde(Stage):  # noqa: N801
    """See the module docstring; parameters as in the reference
    (``kde.py:18-48``)."""

    def __init__(
        self,
        bw_method="silverman",
        coszen_name="reco_coszen",
        oversample=10,
        coszen_reflection=0.25,
        adaptive=True,
        alpha=0.1,
        stack_pid=True,
        stash_hists=False,
        bootstrap=False,
        bootstrap_niter=10,
        bootstrap_seed=None,
        linearize_log_dims=True,
        **std_kwargs,
    ):
        self.bw_method = bw_method
        self.coszen_name = coszen_name
        self.oversample = int(oversample)
        self.coszen_reflection = float(coszen_reflection)
        self.adaptive = adaptive
        self.alpha = float(alpha)
        self.stack_pid = stack_pid
        self.stash_hists = stash_hists
        self.stash_valid = False
        self.bootstrap = bootstrap
        self.bootstrap_niter = int(bootstrap_niter)
        self.bootstrap_seed = (
            int(bootstrap_seed) if bootstrap_seed is not None else None
        )
        self.linearize_log_dims = linearize_log_dims
        self.stashed_hists = None
        self.stashed_errors = None
        super().__init__(
            expected_params=(),
            expected_container_keys=("weights",),
            **std_kwargs,
        )
        self.regularized_apply_mode = None
        #: prepared KDE histograms, by (device, dtype)
        self._plans = {}

    def setup_function(self):
        """Replace log dimensions by linear binnings of the log of the
        variable (reference ``kde.py:109-137``)."""
        self._plans = {}
        if not self.linearize_log_dims:
            self.regularized_apply_mode = self.apply_mode
            return
        dimensions = []
        for dim in self.apply_mode:
            if dim.is_lin:
                new_dim = deepcopy(dim)
            elif dim.is_irregular:
                new_dim = OneDimBinning(
                    dim.name, bin_edges=np.log(dim.bin_edges.magnitude)
                )
            else:
                new_dim = OneDimBinning(
                    dim.name,
                    domain=np.log(np.asarray(dim.domain.magnitude)),
                    num_bins=dim.num_bins,
                )
            dimensions.append(new_dim)
        self.regularized_apply_mode = MultiDimBinning(
            dimensions, name=self.apply_mode.name
        )

    def _plan(self, device, dtype):
        key = (str(device), dtype)
        if key not in self._plans:
            self._plans[key] = KDEPlan(
                self.regularized_apply_mode, coszen_name=self.coszen_name,
                coszen_reflection=self.coszen_reflection,
                oversample=self.oversample, stack_pid=self.stack_pid,
                device=device, dtype=dtype)
        return self._plans[key]

    def _kwargs(self):
        return dict(bw_method=self.bw_method, adaptive=self.adaptive,
                    alpha=self.alpha)

    def _sample(self, container):
        """(..., N, D): the events' coordinates in the regularized binning's
        order, the log of the log dimensions."""
        cols = []
        for dim, orig in zip(self.regularized_apply_mode, self.apply_mode):
            vals = container[dim.name]
            if orig.is_log and self.linearize_log_dims:
                vals = torch.log(vals)
            cols.append(vals)
        return torch.stack(cols, dim=-1)

    # stacked-container support: (C, n_pad) events of every category, one
    # batch of (lanes x categories x PID channels) densities
    supports_stacked = True

    def stacked_ok(self):
        return not self.bootstrap and not self.stash_hists

    def _apply_stacked(self, container):
        container.representation = "events"
        sample = self._sample(container)  # ([B,] C, n_pad, D)
        weights = container["weights"]  # ([B,] C, n_pad)
        hists = self._plan(container.device, weights.dtype)(
            sample, weights, real=container.real_events, **self._kwargs())
        container.representation = self.apply_mode
        container["weights"] = hists  # ([B,] C, size)

    def apply(self):
        # the KDE reads the events' weights as they are: no switch of
        # representation before apply_function (reference kde.py:139-152)
        self._timed(self.apply_function, self.apply_times)

    def _traced(self, weights):
        return self._template_mode or traced(weights)

    def apply_function(self):
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._apply_stacked(container)
                continue
            if self.stash_valid:
                self.data.representation = self.apply_mode
                container["weights"] = self.stashed_hists[
                    container.name].clone()
                if self.bootstrap:
                    container["errors"] = self.stashed_errors[
                        container.name].clone()
                continue

            container.representation = "events"
            sample = self._sample(container)
            weights = container["weights"]
            if (self.stash_hists or self.bootstrap) and self._traced(weights):
                raise TypeError(
                    "kde stage: stash_hists=True or bootstrap=True cannot run"
                    " inside a compiled template (the stash would keep the"
                    " histograms of one evaluation as constants; the"
                    " bootstrap draws on the host); set them False or run"
                    " the pipeline eagerly"
                )
            if self.bootstrap:
                kde_map, kde_errors = self._bootstrap(container, sample,
                                                      weights)
            else:
                kde_map = self._plan(container.device, weights.dtype)(
                    sample, weights, **self._kwargs())

            self.data.representation = self.apply_mode
            container["weights"] = kde_map
            if self.bootstrap:
                container["errors"] = kde_errors

            if self.stash_hists:
                if self.stashed_hists is None:
                    self.stashed_hists = {}
                    self.stashed_errors = {}
                self.stashed_hists[container.name] = kde_map.detach().clone()
                if self.bootstrap:
                    self.stashed_errors[container.name] = \
                        kde_errors.detach().clone()

        self.stash_valid = self.stash_hists

    def _bootstrap(self, container, sample, weights):
        """(mean, std) over `bootstrap_niter` multinomial resamplings of the
        container's events (the draws on the host, from
        ``np.random.default_rng(bootstrap_seed)``, as in the JAX stage),
        evaluated as one float64 batch of replicates."""
        if weights.dim() != 1:
            raise NotImplementedError(
                "bootstrap errors take one parameter point (no lanes)")
        rng = np.random.default_rng(self.bootstrap_seed)
        n = container.size
        counts = np.stack([
            np.bincount(rng.integers(n, size=n), minlength=n)
            for _ in range(self.bootstrap_niter)
        ])
        device = container.device
        w = weights.detach().to(torch.float64) * torch.as_tensor(
            counts, dtype=torch.float64, device=device)
        maps = self._plan(device, torch.float64)(
            sample.detach().to(torch.float64), w, **self._kwargs())
        return (maps.mean(0).to(TORCH_FTYPE),
                maps.std(0, unbiased=False).to(TORCH_FTYPE))


def init_test(**param_kwargs):
    """Instantiation example (the JAX stage's)."""
    from pisa_tpu_torch import ureg

    binning = MultiDimBinning(
        [
            OneDimBinning(
                "reco_energy", num_bins=5, is_log=True,
                domain=[1, 100] * ureg.GeV,
            ),
            OneDimBinning(
                "reco_coszen", num_bins=5, is_lin=True, domain=[-1, 1]
            ),
        ],
        name="kde_test",
    )
    return kde(
        calc_mode="events", apply_mode=binning, stack_pid=False, oversample=2
    )
