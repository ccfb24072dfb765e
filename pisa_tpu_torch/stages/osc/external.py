"""
User-supplied oscillation probabilities (counterpart of
``pisa_tpu/stages/osc/external.py``; reference
``pisa/stages/osc/external.py``): the Earth-layer chains are computed as
prob3 computes them, then a user callable ``osc_prob`` fills the (N, 3, 3)
probabilities, which weight the events as prob3's do.

Set ``stage.osc_prob = fn`` (and optionally ``stage.external_params``),
before or after set-up; the callable is called as
``fn(energy, densities, distances, nubar, **external_params) -> (N, 3, 3)``
with numpy arrays, as the JAX package calls it.

The callable is a host step by design: it takes and returns numpy arrays.
The stage has no free parameter (its params steer the layer geometry, which
a compiled template refuses as free), so a compiled template hoists it
when the stages before it have none either, and runs it once. Where it is
traced instead, the stage keeps the probabilities it uploaded for each
container and computes them again only when the callable, its
``external_params`` or the set-up change: an evaluation then reads nothing
on the host, and a CUDA graph captures it. The probabilities carry no lane
axis; in an evaluation of lanes they are broadcast over the lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.layers import Layers
from pisa_tpu_torch.stages.osc.nusquids import ALL_FLAVS

__all__ = ["external", "init_test"]

_NU = ALL_FLAVS[:6]
_NUBAR = ALL_FLAVS[6:]


class external(Stage):  # noqa: N801
    """Params: detector_depth, earth_model, prop_height, YeI, YeO, YeM."""

    host_param_names = (
        "earth_model", "detector_depth", "prop_height", "YeI", "YeO", "YeM",
    )

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(
                "detector_depth", "earth_model", "prop_height",
                "YeI", "YeO", "YeM",
            ),
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar", "flav", "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )
        self.osc_prob = None
        self.external_params = None
        self.layers = None
        #: per container name, the host inputs of the callable
        self._chains = {}
        #: (callable, its params) and per container name the uploaded
        #: probabilities they gave
        self._probs_key = None
        self._probs = {}

    def setup_function(self):
        self.layers = Layers(self.params.earth_model.value,
                             self.params.detector_depth.m_as("km"),
                             self.params.prop_height.m_as("km"))
        self.layers.setElecFrac(
            *(self.params[n].m_as("dimensionless")
              for n in ("YeI", "YeO", "YeM")))
        self._chains, self._probs_key, self._probs = {}, None, {}
        if self.is_map:
            self.data.link_containers("nu", ALL_FLAVS)
        for container in self.data:
            self.layers.calcLayers(
                container["true_coszen"].detach().cpu().numpy())
            shape = (container.size, self.layers.max_layers)
            self._chains[container.name] = (
                container["true_energy"].detach().cpu().numpy(),
                self.layers.density.reshape(shape),
                self.layers.distance.reshape(shape),
            )
        self.data.unlink_containers()

    def _probabilities(self, name, nubar):
        """The callable's (N, 3, 3) probabilities for one container's
        chains (its nu / nubar link in the binned calc mode), uploaded once
        per callable and params."""
        key = (self.osc_prob, repr(sorted((self.external_params or {})
                                           .items())))
        if key != self._probs_key:
            self._probs_key, self._probs = key, {}
        if name not in self._probs:
            energy, densities, distances = self._chains[
                "nu" if self.is_map else name]
            probs = self.osc_prob(energy, densities, distances, nubar,
                                  **dict(self.external_params or {}))
            self._probs[name] = torch.as_tensor(
                np.asarray(probs, dtype=FTYPE), dtype=TORCH_FTYPE,
                device=self.data.device)
        return self._probs[name]

    def compute_function(self):
        if self.osc_prob is None:
            raise RuntimeError(
                "osc.external requires `stage.osc_prob` to be set to a"
                " callable (energy, densities, distances, nubar, **params)"
                " -> (N, 3, 3)"
            )
        if self.is_map:
            self.data.link_containers("nu", _NU)
            self.data.link_containers("nubar", _NUBAR)
        lanes = self.data.lanes
        for container in self.data:
            probs = self._probabilities(container.name,
                                        int(container["nubar"]))
            if lanes is not None:
                probs = probs.expand((lanes,) + tuple(probs.shape))
            container["probability"] = probs
        self.data.unlink_containers()
        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[..., 0, flav]
            container["prob_mu"] = probs[..., 1, flav]

    def apply_function(self):
        for container in self.data:
            nu_flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                nu_flux[..., 0] * container["prob_e"]
                + nu_flux[..., 1] * container["prob_mu"]
            )


def init_test(**param_kwargs):
    """Instantiation example (a vacuum-like dummy probability callable)."""
    param_set = ParamSet(
        [
            Param(name="detector_depth", value=2 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=20 * ureg.km, **param_kwargs),
            Param(
                name="earth_model", value="osc/PREM_4layer.dat", **param_kwargs
            ),
            Param(name="YeI", value=0.4656, **param_kwargs),
            Param(name="YeO", value=0.4656, **param_kwargs),
            Param(name="YeM", value=0.4957, **param_kwargs),
        ]
    )
    stage = external(params=param_set)

    def dummy_prob(energy, densities, distances, nubar):
        n = energy.shape[0]
        probs = np.zeros((n, 3, 3), dtype=FTYPE)
        probs[:, 0, 0] = 1.0
        probs[:, 1, 1] = 0.5
        probs[:, 1, 2] = 0.5
        probs[:, 2, 2] = 1.0
        return probs

    stage.osc_prob = dummy_prob
    return stage
