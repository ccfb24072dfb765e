"""
Continuous detector systematics from SnowStorm ensembles (counterpart of
``pisa_tpu/stages/cont_sys/snowstorm_hist.py``; reference
``pisa/stages/cont_sys/snowstorm_hist.py``): the simulation is split by
each sampled systematic about its central value, both halves are
histogrammed, and their difference gives a per-bin linear relative
gradient; the per-bin scale is ``prod_s 1 + (p_s - central_s) * grad_s``,
clipped at 0.

The gradients are computed on the host in numpy at the first compute (and
again when an ``additional_params`` value moves beyond its tolerance), from
the weights as they reach this stage, and uploaded. The scale is then torch
ops with no host read, differentiable in the systematics, so that a
compiled template with the systematics free captures. An additional param
that is free in a compiled template raises TypeError, as the JAX package's
trace of its tolerance check does.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.core.translation import histogram

__all__ = ["snowstorm_hist", "init_test"]


def _parse(v, default=None):
    if isinstance(v, str):
        return ast.literal_eval(v)
    return default if v is None else v


class snowstorm_hist(Stage):  # noqa: N801
    """Parameters: systematics, simulation_dists ('gauss' or 'uniform'),
    simulation_dists_params ((mean, std) or (min, max)),
    additional_params, tolerances. Events calc mode; binned apply mode
    (the output binning by default)."""

    def __init__(self, systematics, simulation_dists, simulation_dists_params,
                 additional_params=None, tolerances=None, **std_kwargs):
        self.systematics = list(_parse(systematics))
        self.simulation_dists = list(_parse(simulation_dists))
        self.simulation_dists_params = list(_parse(simulation_dists_params))
        self.additional_params = list(_parse(additional_params, []))
        tol = _parse(tolerances, [0] * len(self.additional_params))
        self.tol = np.asarray(tol, dtype=FTYPE)
        if len(self.simulation_dists) != len(self.systematics):
            raise ValueError("one simulation_dist per systematic required")
        for sd in self.simulation_dists:
            if sd.lower() not in ("gauss", "uniform"):
                raise ValueError(f"unknown simulation dist {sd!r}")

        #: container name -> {systematic: per-bin gradient on the device}
        self.grads = {}
        self.central_values = []
        self.additional_params_values = None

        super().__init__(
            expected_params=tuple(self.systematics + self.additional_params),
            expected_container_keys=tuple(["weights"] + self.systematics),
            **std_kwargs,
        )

    def setup_function(self):
        if self.apply_mode is None:
            self.apply_mode = self.data["output_binning"]
        self.central_values = []
        for sd, sp in zip(self.simulation_dists,
                          self.simulation_dists_params):
            if sd.lower() == "gauss":
                self.central_values.append(sp[0])
            else:
                self.central_values.append(sum(sp) / 2)
        for container in self.data:
            self.grads[container.name] = {}
        self.additional_params_values = None

    def _calc_gradients(self, container):
        """{systematic: per-bin relative gradient} of `container`, on the
        host (``pisa_tpu/stages/cont_sys/snowstorm_hist.py:93-131``), then
        uploaded."""
        container.representation = "events"

        def host(key):
            value = container[key].detach()
            if container.lanes is not None:
                value = value[0]
            return value.cpu()

        sample = [host(d.name) for d in self.apply_mode]
        weights = host("weights")
        grads = {}
        for i, sys in enumerate(self.systematics):
            vals = host(sys)
            above = vals > self.central_values[i]
            below = vals < self.central_values[i]
            h1 = histogram([s[above] for s in sample], weights[above],
                           self.apply_mode).numpy()
            h2 = histogram([s[below] for s in sample], weights[below],
                           self.apply_mode).numpy()
            with np.errstate(divide="ignore", invalid="ignore"):
                if self.simulation_dists[i].lower() == "gauss":
                    # the correction factor of eq. 2.12 of the SnowStorm
                    # paper
                    corr = (1.0 / self.simulation_dists_params[i][1]
                            ) * np.sqrt(np.pi / 2)
                    g = 2 * (h1 - h2) * corr / (h1 + h2)
                else:
                    diff = (self.simulation_dists_params[i][1]
                            - self.simulation_dists_params[i][0]) / 2
                    g = 2 * (h1 - h2) / diff / (h1 + h2)
            grads[sys] = torch.as_tensor(
                np.nan_to_num(g).ravel().astype(FTYPE),
                device=container.device)
        return grads

    def _additional_values(self):
        values = []
        for name in self.additional_params:
            value = self.params[name].value.magnitude
            if isinstance(value, torch.Tensor):
                raise TypeError(
                    f"snowstorm_hist: additional param {name!r} is free in a"
                    " compiled template; its tolerance check needs its value"
                    " on the host")
            values.append(value)
        return np.array(values, dtype=FTYPE)

    def compute_function(self):
        vals = self._additional_values()
        calc_grads = self.additional_params_values is None or np.any(
            np.abs(vals - self.additional_params_values) > self.tol)
        if calc_grads:
            self.additional_params_values = vals

        for container in self.data:
            if calc_grads or not self.grads[container.name]:
                self.grads[container.name] = self._calc_gradients(container)

            container.representation = self.apply_mode
            scale = None
            for i, sys in enumerate(self.systematics):
                shift = in_data_type(self.params[sys].value.magnitude
                                     - self.central_values[i])
                factor = 1.0 + shift * self.grads[container.name][sys]
                scale = factor if scale is None else scale * factor
            if scale is None:
                scale = torch.ones(self.apply_mode.size,
                                   device=container.device)
            scale = torch.clamp(scale, min=0.0)
            if container.lanes is not None and scale.dim() == 1:
                scale = scale.expand(container.lanes, -1)
            container["syst_scale"] = scale

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["syst_scale"])


def init_test(**param_kwargs):
    """Instantiation example."""
    param_kwargs.pop("range", None)
    param_set = ParamSet([
        Param(name="dom_eff", value=1.0, range=[0.8, 1.2], **param_kwargs),
        Param(name="deltam31", value=3e-3 * ureg.eV**2,
              range=[1e-3, 7e-3] * ureg.eV**2, **param_kwargs),
    ])
    return snowstorm_hist(
        systematics=["dom_eff"],
        simulation_dists=["gauss"],
        simulation_dists_params=[(1.0, 0.1)],
        additional_params=["deltam31"],
        params=param_set,
        calc_mode="events",
    )
