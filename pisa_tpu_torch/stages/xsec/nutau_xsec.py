"""
nutau CC cross-section model interpolation (counterpart of
``pisa_tpu/stages/xsec/nutau_xsec.py``; reference
``pisa/stages/xsec/nutau_xsec.py``): the per-event scale
``max(0, 1 + f(E) nutau_xsec_scale)``, f the model difference from the
vendored scipy ``interp1d`` pickle, evaluated on the host at set-up; the
scale is torch ops, differentiable in ``nutau_xsec_scale``.

Below the tau-production threshold f is undefined (the pickle gives inf);
the JAX package sets it to -inf, so that its clip gives 0 for a positive
scale, but NaN for a zero one (-inf x 0) and inf for a negative one, and
its gradient in the scale is NaN wherever such an event is (0 x -inf). The
port gives those events the scale 0 for every value of the parameter (the
JAX package's intent, and the reference's ``max(0., nan)``) and a zero
derivative there; it equals the JAX package's wherever that is finite.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["nutau_xsec", "init_test"]

_KEYS = {"nutau_cc": "NuTau", "nutaubar_cc": "NuTauBar"}


class nutau_xsec(Stage):  # noqa: N801
    """Params: nutau_xsec_scale (dimensionless, range [-1, 1])."""

    def __init__(
        self,
        xsec_file="cross_sections/interp_nutau_xsec_protocol2.pckl",
        **std_kwargs,
    ):
        super().__init__(
            expected_params=("nutau_xsec_scale",),
            expected_container_keys=("true_energy", "weights"),
            **std_kwargs,
        )
        self.xsec_file = xsec_file

    def setup_function(self):
        with open(find_resource(self.xsec_file), "rb") as fl:
            interp_dict = pickle.load(fl, encoding="latin1")
        for container in self.data:
            if container.name not in _KEYS:
                continue
            energy = container["true_energy"].detach().cpu().numpy()
            func = np.asarray(interp_dict[_KEYS[container.name]](energy),
                              dtype=FTYPE)
            below = ~np.isfinite(func)
            # f is stored finite (0 below the threshold), and the mask says
            # where the scale is 0 whatever the parameter
            container["nutau_xsec_func"] = np.where(below, 0.0, func).astype(
                FTYPE)
            container["nutau_below_threshold"] = below

    def compute_function(self):
        scale = in_data_type(
            self.params.nutau_xsec_scale.value.m_as("dimensionless"))
        for container in self.data:
            if container.name in _KEYS:
                factor = torch.clamp(
                    1.0 + container["nutau_xsec_func"] * scale, min=0.0)
                container["nutau_xsec_scale"] = torch.where(
                    container["nutau_below_threshold"], 0.0, factor)

    def apply_function(self):
        for container in self.data:
            if container.name in _KEYS:
                container["weights"] = (
                    container["weights"] * container["nutau_xsec_scale"])


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [Param(name="nutau_xsec_scale", value=1.0, **param_kwargs)]
    )
    return nutau_xsec(params=param_set)
