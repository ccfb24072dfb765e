"""
Effective-area / normalization stage (counterpart of
``pisa_tpu/stages/aeff/aeff.py``; reference ``pisa/stages/aeff/aeff.py``):
``weights *= weighted_aeff * livetime * aeff_scale`` with per-category norms
(nutau_cc_norm for nutau(bar)_cc, nutau_norm for all nutau categories,
nu_nc_norm for NC). On a category-stacked container the per-category scales
are one ``(C,)`` vector (``(B, C)`` in an evaluation of lanes), selected by
name masks that live on the device.
"""

from __future__ import annotations

import torch

from pisa_tpu_torch import ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type

__all__ = ["aeff", "init_test"]


class aeff(Stage):  # noqa: N801
    """Params: livetime, aeff_scale, nutau_cc_norm, nutau_norm, nu_nc_norm."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(
                "livetime",
                "aeff_scale",
                "nutau_cc_norm",
                "nutau_norm",
                "nu_nc_norm",
            ),
            expected_container_keys=("weights", "weighted_aeff"),
            **std_kwargs,
        )
        self._masks = {}  # (category names, device) -> (3, C) bool tensor

    supports_stacked = True

    # weights *= weighted_aeff (static per event) x scale (one scalar per
    # category): the rate-deferral contract (core/stage.py)
    stacked_rate_defer_safe = True
    stacked_static_weight_keys = ("weighted_aeff",)
    supports_shard = True

    def _category_masks(self, container):
        """Which of the categories take nutau_cc_norm, nutau_norm and
        nu_nc_norm: a (3, C) bool tensor on the device, built once."""
        key = (tuple(container.cat_names), container.device)
        if key not in self._masks:
            names = container.cat_names
            self._masks[key] = torch.tensor(
                [[n in ("nutau_cc", "nutaubar_cc") for n in names],
                 ["nutau" in n for n in names],
                 ["nc" in n for n in names]],
                device=container.device,
            )
        return self._masks[key]

    def apply_function(self):
        aeff_scale = self.params.aeff_scale.m_as("dimensionless")
        livetime_s = self.params.livetime.m_as("sec")
        nutau_cc_norm = self.params.nutau_cc_norm.m_as("dimensionless")
        nutau_norm = self.params.nutau_norm.m_as("dimensionless")
        nu_nc_norm = self.params.nu_nc_norm.m_as("dimensionless")

        for container in self.data:
            if getattr(container, "is_stacked", False):
                weights = container["weights"]
                m_cc, m_tau, m_nc = self._category_masks(container)
                one = torch.ones((), dtype=torch.float64,
                                 device=container.device)
                scale = (
                    aeff_scale
                    * livetime_s
                    * torch.where(m_cc, nutau_cc_norm, one)
                    * torch.where(m_tau, nutau_norm, one)
                    * torch.where(m_nc, nu_nc_norm, one)
                ).to(weights.dtype)
                container["weights"] = (
                    weights * container["weighted_aeff"] * scale[..., None]
                )
                continue
            scale = aeff_scale * livetime_s
            if container.name in ("nutau_cc", "nutaubar_cc"):
                scale = scale * nutau_cc_norm
            if "nutau" in container.name:
                scale = scale * nutau_norm
            if "nc" in container.name:
                scale = scale * nu_nc_norm
            container["weights"] = (
                container["weights"] * container["weighted_aeff"]
                * in_data_type(scale)
            )


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="livetime", value=10 * ureg.s, **param_kwargs),
            Param(name="aeff_scale", value=1.0, **param_kwargs),
            Param(name="nutau_cc_norm", value=1.0, **param_kwargs),
            Param(name="nutau_norm", value=1.0, **param_kwargs),
            Param(name="nu_nc_norm", value=1.0, **param_kwargs),
        ]
    )
    return aeff(params=param_set)
