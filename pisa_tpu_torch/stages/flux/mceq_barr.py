"""
MCEq-computed nominal flux and Barr-gradient flux systematics (counterpart
of ``pisa_tpu/stages/flux/mceq_barr.py``; reference
``pisa/stages/flux/mceq_barr.py``): the flux is the spectrally tilted
nominal flux plus per-event MCEq gradients times 26 Barr parameters (9
pion blocks with the pi- ones tied to the pi+ ones through the pion ratio,
4 kaon and 4 antikaon blocks).

Set-up evaluates the scipy splines of the pickled table on the host, once
(the table holds numpy arrays and scipy ``RectBivariateSpline`` objects
only, so it unpickles without the JAX package); a compute is torch ops on
the containers' device: one product of the (N, flavours, 26) gradients
with the parameter vector, so the Barr parameters and ``delta_index`` get
their gradients through compiled templates and nothing is read on the host
(a CUDA-graph capture sees no wait). With ``use_relative_gradients`` the
gradients are scaled by the nominal flux over MCEq's; that ratio of the
gradients to MCEq's flux is formed once at set-up. Like the JAX stage it
runs per container (no stacking).
"""

from __future__ import annotations

import pickle
from bz2 import BZ2File

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.daemonflux_native import value_vector
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["mceq_barr", "spectral_index_scale", "load_gradient_splines",
           "evaluate_splines", "barr_flux", "init_test"]

_NU_LINK = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
]
_NUBAR_LINK = [
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]


def spectral_index_scale(true_energy, energy_pivot, delta_index):
    """(E / E_pivot)^delta_index."""
    return torch.pow(true_energy / energy_pivot, delta_index)


def load_gradient_splines(table_file, gradient_names):
    """The pickled MCEq spline table, checked to hold every gradient."""
    spline_file = find_resource(table_file)
    logging.info("Loading MCEq spline tables from %s", spline_file)
    with BZ2File(spline_file) as f:
        splines = pickle.load(f, encoding="latin1")
    for name in gradient_names:
        if name not in splines:
            raise ValueError(f"gradient param {name!r} missing from table")
    return splines


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


def evaluate_splines(splines, gradient_names, container, n_flavs,
                     with_flux=True):
    """(MCEq's flux (N, n_flavs) or None, gradients (N, n_flavs, n_grads))
    at the container's true energies and |coszen|, on the host in float64:
    the nu or nubar splines by the container's sign."""
    log_e = np.log(_host(container["true_energy"]))
    abs_cz = np.abs(_host(container["true_coszen"]))
    sfx = "" if int(container["nubar"]) > 0 else "bar"
    flavs = ["nue", "numu", "nutau"][:n_flavs]
    mceq = None
    if with_flux:
        arb = splines[gradient_names[0]]
        mceq = np.stack([arb[f"{f}{sfx}"](abs_cz, log_e, grid=False)
                         for f in flavs], axis=1)
    grads = np.stack([
        np.stack([splines[g][f"d{f}{sfx}"](abs_cz, log_e, grid=False)
                  for f in flavs], axis=1)
        for g in gradient_names], axis=2)
    return mceq, grads


def barr_flux(base, gradients, gparams):
    """``max(0, base + gradients @ gparams)``: base (..., N, F), gradients
    (..., N, F, C), gparams (C,) or (B, C) in an evaluation of B lanes."""
    if gparams.dim() == 2:
        gparams = gparams[:, None, :, None]  # (B, 1, C, 1)
    else:
        gparams = gparams[:, None]  # (C, 1)
    return torch.clamp(base + (gradients @ gparams).squeeze(-1), min=0.0)


class mceq_barr(Stage):  # noqa: N801
    """Parameters: table_file, include_nutau_flux, use_honda_nominal_flux,
    use_relative_gradients; params as in the reference."""

    BARR_NAMES = ["a", "b", "c", "d", "e", "f", "g", "h", "i",  # pions
                  "w", "x", "y", "z"]  # kaons

    def __init__(
        self,
        table_file,
        include_nutau_flux=False,
        use_honda_nominal_flux=True,
        use_relative_gradients=True,
        **std_kwargs,
    ):
        self.table_file = table_file
        self.include_nutau_flux = include_nutau_flux
        self.use_honda_nominal_flux = use_honda_nominal_flux
        self.use_relative_gradients = use_relative_gradients
        self.gradient_param_names = [
            n + s for n in self.BARR_NAMES for s in ("+", "-")
        ]
        expected_params = (
            "pion_ratio",
            *(f"barr_{n}_Pi" for n in self.BARR_NAMES[:9]),
            *(f"barr_{n}_K" for n in self.BARR_NAMES[9:]),
            *(f"barr_{n}_antiK" for n in self.BARR_NAMES[9:]),
            "delta_index",
            "energy_pivot",
        )
        expected_container_keys = ["true_energy", "true_coszen", "nubar"]
        if use_honda_nominal_flux:
            expected_container_keys += ["nu_flux_nominal",
                                        "nubar_flux_nominal"]
        super().__init__(
            expected_params=expected_params,
            expected_container_keys=tuple(expected_container_keys),
            **std_kwargs,
        )

    def setup_function(self):
        splines = load_gradient_splines(self.table_file,
                                        self.gradient_param_names)
        n_flavs = 3 if self.include_nutau_flux else 2
        if self.is_map:
            self.data.link_containers("nu", _NU_LINK)
            self.data.link_containers("nubar", _NUBAR_LINK)
        for container in self.data:
            mceq, grads = evaluate_splines(
                splines, self.gradient_param_names, container, n_flavs)
            container["nu_flux_mceq"] = mceq.astype(FTYPE)
            if not self.use_honda_nominal_flux:
                container["nu_flux_nominal"] = mceq.astype(FTYPE)
            if self.use_relative_gradients:
                # the gradients relative to MCEq's flux, which a compute
                # scales by the nominal flux (the spectral scale cancels)
                grads = grads / mceq[..., None]
            container["gradients"] = grads.astype(FTYPE)
        self.data.unlink_containers()

    @staticmethod
    def antipion_production(barr_var, pion_ratio):
        """pi- Barr param from the pi+ param and the (delta) pion ratio
        (reference ``mceq_barr.py:antipion_production``)."""
        return (1 + barr_var) / (1 + pion_ratio) - 1

    def _gradient_values(self):
        """{gradient name: magnitude} (numbers, or tensors in a compiled
        template)."""
        p = self.params
        pion_ratio = p.pion_ratio.m_as("dimensionless")
        values = {}
        for n in self.BARR_NAMES[:9]:
            plus = p[f"barr_{n}_Pi"].m_as("dimensionless")
            values[n + "+"] = plus
            values[n + "-"] = self.antipion_production(plus, pion_ratio)
        for n in self.BARR_NAMES[9:]:
            values[n + "+"] = p[f"barr_{n}_K"].m_as("dimensionless")
            values[n + "-"] = p[f"barr_{n}_antiK"].m_as("dimensionless")
        return values

    def _nominal_key(self, container):
        if self.use_honda_nominal_flux and int(container["nubar"]) < 0:
            return "nubar_flux_nominal"
        return "nu_flux_nominal"

    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _NU_LINK)
            self.data.link_containers("nubar", _NUBAR_LINK)
        delta_index = in_data_type(
            self.params.delta_index.m_as("dimensionless"))
        energy_pivot = self.params.energy_pivot.m_as("GeV")
        gparams = value_vector(self._gradient_values(),
                               self.gradient_param_names, self.data.lanes,
                               dtype=TORCH_FTYPE, device=self.data.device)
        for container in self.data:
            grads = container["gradients"]
            n_flavs = grads.shape[-2]
            nominal = container[self._nominal_key(container)][..., :n_flavs]
            scale = spectral_index_scale(container["true_energy"],
                                         energy_pivot, delta_index)
            base = nominal * scale[..., None]
            if self.use_relative_gradients:
                grads = nominal[..., None] * grads
            container["nu_flux"] = barr_flux(base, grads, gparams)
        self.data.unlink_containers()


def init_test(**param_kwargs):
    """Instantiation example."""
    names = mceq_barr.BARR_NAMES
    params = [Param(name="pion_ratio", value=0.0, **param_kwargs)]
    params += [Param(name=f"barr_{n}_Pi", value=0.0, **param_kwargs)
               for n in names[:9]]
    params += [Param(name=f"barr_{n}_K", value=0.0, **param_kwargs)
               for n in names[9:]]
    params += [Param(name=f"barr_{n}_antiK", value=0.0, **param_kwargs)
               for n in names[9:]]
    params += [
        Param(name="delta_index", value=0.0, **param_kwargs),
        Param(name="energy_pivot", value=25 * ureg.GeV, **param_kwargs),
    ]
    return mceq_barr(
        table_file=(
            "flux/MCEq_flux_gradient_splines_2212_GlobalSplineFitBeta"
            "_SIBYLL23C.pckl.bz2"
        ),
        include_nutau_flux=False,
        use_honda_nominal_flux=True,
        params=ParamSet(params),
    )
