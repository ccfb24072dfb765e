"""
Pre-calculated GENIE systematics (counterpart of
``pisa_tpu/stages/xsec/genie_sys.py``; reference
``pisa/stages/xsec/genie_sys.py``): the per-event quadratic weight
modification ``weights *= max(0, prod_i 1 + (lin_i + quad_i p_i) p_i)``
in torch ops, differentiable in every ``p_i``.
"""

from __future__ import annotations

import re

import torch

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.log import logging

__all__ = ["genie_sys", "init_test"]


class genie_sys(Stage):  # noqa: N801
    """Params: one per entry of `interactions` (e.g. Genie_Ma_QE)."""

    def __init__(
        self,
        interactions="Genie_Ma_QE, Genie_Ma_RES",
        names="maccqe, maccres",
        **std_kwargs,
    ):
        interactions = re.split(r"\W+", interactions)
        names = re.split(r"\W+", names)
        if len(interactions) != len(names):
            raise ValueError("specify a name for each interaction")
        self.interactions = interactions
        self.names = names
        expected_container_keys = (
            [f"linear_fit_{n}" for n in names]
            + [f"quad_fit_{n}" for n in names]
            + ["weights"]
        )
        super().__init__(
            expected_params=tuple(interactions),
            expected_container_keys=tuple(expected_container_keys),
            **std_kwargs,
        )

    def setup_function(self):
        for name in self.interactions:
            rng = self.params[name].range
            if rng is not None and (
                rng[0].magnitude < -2.0 or rng[1].magnitude > 2.0
            ):
                logging.warning(
                    "%s parameter bounds beyond the [-2, 2] interpolation"
                    " range; this voids the warranty...",
                    name,
                )

    def apply_function(self):
        values = [in_data_type(self.params[name].m_as("dimensionless"))
                  for name in self.interactions]
        for container in self.data:
            factor = 1.0
            for value, name in zip(values, self.names):
                lin = container[f"linear_fit_{name}"]
                quad = container[f"quad_fit_{name}"]
                factor = factor * (1.0 + (lin + quad * value) * value)
            container["weights"] = container["weights"] * torch.clamp(
                factor, min=0.0)


def init_test(**param_kwargs):
    """Instantiation example."""
    param_kwargs.pop("range", None)
    param_set = ParamSet([
        Param(name="Genie_Ma_QE", value=0.0, range=[-1.0, 1.0],
              **param_kwargs),
        Param(name="Genie_Ma_RES", value=0.0, range=[-1.0, 1.0],
              **param_kwargs),
    ])
    return genie_sys(params=param_set)
