"""
The per-bin inputs of the generalized Poisson-gamma likelihood
(counterpart of ``pisa_tpu/stages/likelihood/generalized_llh_params.py``;
reference ``pisa/stages/likelihood/generalized_llh_params.py:59``): each
bin's count of MC events, the mean adjustment, the empty-bin pseudo-weight
(strategy 2 of arXiv:1902.08831), and the alpha and beta of the mixture.

The set-up counts the MC events per bin on the host (numpy). An apply sums
the weights and the squared weights per bin with ``index_add_`` over the
events' 'bin_indices' (``utils.add_indices``) on the pipeline's device,
differentiable in the weights, so a fit under the generalized likelihood
gets its gradient through alpha and beta.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage

__all__ = ["generalized_llh_params", "init_test", "PSEUDO_WEIGHT"]

PSEUDO_WEIGHT = 0.001


class generalized_llh_params(Stage):  # noqa: N801
    """Adds llh_alphas, llh_betas and n_mc_events; replaces the binned
    weights by their sums with the empty bins filled by the
    pseudo-weight."""

    def __init__(self, **std_kwargs):
        if not isinstance(std_kwargs.get("apply_mode"), MultiDimBinning):
            raise ValueError(
                "generalized_llh_params requires a binning as apply_mode")
        super().__init__(expected_params=(),
                         expected_container_keys=("weights", "bin_indices"),
                         **std_kwargs)

    def setup_function(self):
        n_bins = self.apply_mode.size
        for container in self.data:
            self.data.representation = "events"
            idx = container["bin_indices"].cpu().numpy()
            in_range = (idx >= 0) & (idx < n_bins)
            if "kfold_mask" in container.keys:
                in_range &= container["kfold_mask"].cpu().numpy().astype(bool)
            counts = np.bincount(idx[in_range], minlength=n_bins).astype(FTYPE)

            self.data.representation = self.apply_mode
            for key in ("llh_alphas", "llh_betas", "old_sum"):
                container[key] = np.zeros(n_bins, dtype=FTYPE)
            container["n_mc_events"] = counts
            # the mean adjustment (reference :140-147)
            mean_n = float(np.mean(counts))
            container.set_aux_data(
                "mean_adjustment",
                -(1.0 - mean_n) + 1.0e-3 if mean_n < 1.0 else 0.0)
            container.set_aux_data("pseudo_weight", PSEUDO_WEIGHT)

    def apply_function(self):
        n_bins = self.apply_mode.size
        for container in self.data:
            self.data.representation = self.apply_mode
            n_mc = container["n_mc_events"]

            self.data.representation = "events"
            idx = container["bin_indices"].long()
            w = container["weights"]
            if "kfold_mask" in container.keys:
                w = w * container["kfold_mask"]
            # the events out of range go to a dropped slot at n_bins
            in_range = (idx >= 0) & (idx < n_bins)
            seg = torch.where(in_range, idx, n_bins)
            w_in = torch.where(in_range, w, torch.zeros_like(w))
            sums = torch.zeros((2, n_bins + 1), dtype=w.dtype, device=w.device)
            sums = sums.index_add(1, seg, torch.stack([w_in, w_in * w_in]))
            sum_w, sum_w2 = sums[:, :n_bins].unbind()

            mean_adjustment = container["mean_adjustment"]
            pseudo_weight = container["pseudo_weight"]
            empty = n_mc == 0
            n_eff = torch.where(empty, 1.0, n_mc)
            # empty-bin strategy 2: one event of the pseudo-weight
            sum_w_f = torch.where(empty, pseudo_weight, sum_w)
            sum_w2_f = torch.where(empty, pseudo_weight**2, sum_w2)

            mean_w = sum_w_f / n_eff
            # the weights' population variance (reference :228-230)
            var_w = torch.clamp(sum_w2_f / n_eff - mean_w**2, min=0.0)
            var_z = var_w + mean_w**2
            beta = torch.where(var_z != 0, mean_w / var_z, 1.0)
            trad_alpha = torch.where(var_z != 0, mean_w**2 / var_z,
                                     PSEUDO_WEIGHT)
            alpha = (n_eff + mean_adjustment) * trad_alpha

            self.data.representation = self.apply_mode
            container["llh_alphas"] = alpha
            container["llh_betas"] = beta
            container["old_sum"] = sum_w
            container["weights"] = sum_w_f


def init_test(**param_kwargs):
    """Instantiation example."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.binning import OneDimBinning

    binning = MultiDimBinning(
        [
            OneDimBinning(
                "true_energy", num_bins=5, is_log=True,
                domain=[1, 100] * ureg.GeV,
            )
        ],
        name="test",
    )
    return generalized_llh_params(apply_mode=binning, calc_mode="events")
