"""
Reduced-parameter MCEq/Barr flux systematics (counterpart of
``pisa_tpu/stages/flux/mceq_barr_red.py``; reference
``pisa/stages/flux/mceq_barr_red.py``): :mod:`flux.mceq_barr` with the
correlated pion-production blocks collapsed into one 'af' parameter (8
Barr blocks instead of 13), the gradients applied absolutely to an
external (Honda) nominal flux: the reduced-scheme table stores gradients
only. Set-up on the host, computes in torch ops, per container, as
:mod:`flux.mceq_barr`, whose helpers it uses.
"""

from __future__ import annotations

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.stages.flux.mceq_barr import (
    _NU_LINK,
    _NUBAR_LINK,
    barr_flux,
    evaluate_splines,
    load_gradient_splines,
    mceq_barr,
    spectral_index_scale,
)
from pisa_tpu_torch.utils.daemonflux_native import value_vector

__all__ = ["mceq_barr_red", "init_test"]


class mceq_barr_red(Stage):  # noqa: N801
    """Params: pion_ratio, barr_{af,g,h,i}_Pi, barr_{w,x,y,z}_{K,antiK},
    delta_index, energy_pivot."""

    BARR_NAMES = ["af", "g", "h", "i", "w", "x", "y", "z"]
    PION_NAMES = ["af", "g", "h", "i"]
    KAON_NAMES = ["w", "x", "y", "z"]

    def __init__(self, table_file, include_nutau_flux=False, **std_kwargs):
        self.table_file = table_file
        self.include_nutau_flux = include_nutau_flux
        self.gradient_param_names = [
            n + s for n in self.BARR_NAMES for s in ("+", "-")
        ]
        expected_params = (
            "pion_ratio",
            *(f"barr_{n}_Pi" for n in self.PION_NAMES),
            *(f"barr_{n}_K" for n in self.KAON_NAMES),
            *(f"barr_{n}_antiK" for n in self.KAON_NAMES),
            "delta_index",
            "energy_pivot",
        )
        super().__init__(
            expected_params=expected_params,
            expected_container_keys=(
                "true_energy", "true_coszen", "nubar",
                "nu_flux_nominal", "nubar_flux_nominal",
            ),
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
            _, grads = evaluate_splines(splines, self.gradient_param_names,
                                        container, n_flavs, with_flux=False)
            container["gradients"] = grads.astype(FTYPE)
        self.data.unlink_containers()

    def _gradient_values(self):
        p = self.params
        pion_ratio = p.pion_ratio.m_as("dimensionless")
        values = {}
        for n in self.PION_NAMES:
            plus = p[f"barr_{n}_Pi"].m_as("dimensionless")
            values[n + "+"] = plus
            values[n + "-"] = mceq_barr.antipion_production(plus, pion_ratio)
        for n in self.KAON_NAMES:
            values[n + "+"] = p[f"barr_{n}_K"].m_as("dimensionless")
            values[n + "-"] = p[f"barr_{n}_antiK"].m_as("dimensionless")
        return values

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
            key = ("nu_flux_nominal" if int(container["nubar"]) > 0
                   else "nubar_flux_nominal")
            grads = container["gradients"]
            nominal = container[key][..., :grads.shape[-2]]
            scale = spectral_index_scale(container["true_energy"],
                                         energy_pivot, delta_index)
            container["nu_flux"] = barr_flux(nominal * scale[..., None],
                                             grads, gparams)
        self.data.unlink_containers()


def init_test(**param_kwargs):
    """Instantiation example."""
    params = [Param(name="pion_ratio", value=0.0, **param_kwargs)]
    params += [Param(name=f"barr_{n}_Pi", value=0.0, **param_kwargs)
               for n in mceq_barr_red.PION_NAMES]
    params += [Param(name=f"barr_{n}_K", value=0.0, **param_kwargs)
               for n in mceq_barr_red.KAON_NAMES]
    params += [Param(name=f"barr_{n}_antiK", value=0.0, **param_kwargs)
               for n in mceq_barr_red.KAON_NAMES]
    params += [
        Param(name="delta_index", value=0.0, **param_kwargs),
        Param(name="energy_pivot", value=25 * ureg.GeV, **param_kwargs),
    ]
    return mceq_barr_red(
        table_file=(
            "flux/MCEq_flux_gradient_splines_2212_GlobalSplineFitBeta"
            "_SIBYLL23C_reduced_scheme.pckl.bz2"
        ),
        params=ParamSet(params),
    )
