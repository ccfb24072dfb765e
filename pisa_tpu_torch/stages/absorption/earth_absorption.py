"""
Neutrino absorption in the Earth (counterpart of
``pisa_tpu/stages/absorption/earth_absorption.py``; reference
``pisa/stages/absorption/earth_absorption.py``): the survival probability
``exp(-rho_int * xsec * N_A)``, with the water-equivalent column depth
rho_int from the Earth-layer chains (``ops/osc/layers.py``, electron
fraction 1 for the total matter density) and the per-flavour total (CC +
NC) cross-section interpolated in the vendored GENIE
``cross_sections/cross_sections.json``.

Set-up builds the chains and interpolates the cross-sections on the host;
a compute is the column-depth sum over the padded layer axis and the
exponential, in torch ops on the containers' device (nothing is read on
the host). The stage has no parameters.

The chains are kept under the stage's own keys, ``absorption_densities``
and ``absorption_distances``. The JAX package stores them as
``densities`` and ``distances``, the keys its prob3 reads at every compute:
with both stages in a pipeline, prob3 then oscillates with the total
matter density in place of the electron density (``tests/
test_torch_flux_xsec.py`` holds the port against the JAX stages with the
two sets kept apart).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.ops.osc.layers import Layers
from pisa_tpu_torch.utils.fileio import from_file
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["earth_absorption", "init_test", "N_A"]

N_A = 6.022e23  # nuclei per mol

_ALL_NU = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_FLAV_KEY = {
    (0, 1): "nue", (0, -1): "nue_bar",
    (1, 1): "numu", (1, -1): "numu_bar",
    (2, 1): "nutau", (2, -1): "nutau_bar",
}


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class earth_absorption(Stage):  # noqa: N801
    """Parameters: earth_model (PREM path), xsec_file (GENIE JSON),
    xsec_version, detector_depth, prop_height."""

    def __init__(
        self,
        earth_model,
        xsec_file="cross_sections/cross_sections.json",
        xsec_version="genie_2.8.6",
        detector_depth=2.0 * ureg.km,
        prop_height=20.0 * ureg.km,
        **std_kwargs,
    ):
        super().__init__(
            expected_params=(),
            expected_container_keys=(
                "true_coszen", "true_energy", "flav", "nubar", "weights",
            ),
            **std_kwargs,
        )
        self.earth_model = earth_model
        self.xsec_file = xsec_file
        self.xsec_version = xsec_version
        self.detector_depth = detector_depth.m_as("km")
        self.prop_height = prop_height.m_as("km")
        self.layers = None
        self.xsec_tables = None

    def setup_function(self):
        self.layers = Layers(self.earth_model, self.detector_depth,
                             self.prop_height)
        # electron fraction 1 -> total matter density (cf. reference)
        self.layers.setElecFrac(1.0, 1.0, 1.0)
        xs = from_file(find_resource(self.xsec_file))[self.xsec_version]
        self.xsec_tables = {
            "energy": np.asarray(xs["energy"], dtype=np.float64),
            "xsec": {
                k: np.asarray(v["cc"], dtype=np.float64)
                + np.asarray(v["nc"], dtype=np.float64)
                for k, v in xs["xsec"].items()
            },
        }
        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        for container in self.data:
            self.layers.calcLayers(_host(container["true_coszen"]))
            shape = (container.size, self.layers.max_layers)
            container["absorption_densities"] = self.layers.density.reshape(
                shape)
            container["absorption_distances"] = \
                self.layers.distance.reshape(shape)
        self.data.unlink_containers()
        for container in self.data:
            container["xsection"] = self._xsec_cm2(
                int(container["flav"]), int(container["nubar"]),
                _host(container["true_energy"])).astype(FTYPE)

    def _xsec_cm2(self, flav, nubar, energy):
        """Per-nucleon total cross-section in cm^2 (tables in m^2)."""
        table = self.xsec_tables["xsec"][_FLAV_KEY[(flav, nubar)]]
        return np.interp(energy, self.xsec_tables["energy"], table) * 1e4

    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        for container in self.data:
            # water-equivalent column depth in cm (distances in km)
            container["rho_int"] = (
                container["absorption_distances"]
                * container["absorption_densities"]).sum(-1) * 1e5
        self.data.unlink_containers()
        for container in self.data:
            container["survival_prob"] = torch.exp(
                -container["rho_int"] * container["xsection"] * N_A)

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["survival_prob"])


def init_test(**param_kwargs):
    """Instantiation example."""
    return earth_absorption(earth_model="osc/PREM_4layer.dat")
