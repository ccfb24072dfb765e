"""
Nominal atmospheric flux from Honda tables via integral-preserving splines
(counterpart of ``pisa_tpu/stages/flux/honda_ip.py``; reference
``pisa/stages/flux/honda_ip.py``).

The flux table is a fixed (host) parameter and the nominal flux carries no
free parameters, so evaluation is host-side numpy/scipy
(``pisa_tpu_torch.utils.flux_weights``), run when the stage computes; the
per-point flux arrays are then uploaded to the pipeline's device.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.flux_weights import (
    calculate_2d_flux_weights,
    load_2d_table,
)

__all__ = ["honda_ip", "init_test"]

_ALL_NU = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class honda_ip(Stage):  # noqa: N801
    """Fills nu_flux_nominal / nubar_flux_nominal [:, (nue, numu)]."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=("flux_table",),
            expected_container_keys=("true_energy", "true_coszen"),
            **std_kwargs,
        )
        self.flux_table = None

    # the flux table path steers host-side table loading
    host_param_names = ("flux_table",)

    # fills the nominal flux fields only; never touches the event weights
    stacked_rate_defer_safe = True
    # per point, with no host state per container
    supports_shard = True

    def stacked_ok(self):
        """Grid calc mode only: the nominal flux on the shared calc grid is
        the same for every category, one shared tensor of the stacked
        container."""
        return self.is_map

    def setup_function(self):
        self.flux_table = load_2d_table(str(self.params.flux_table.value))

    def compute_function(self):
        if self.is_map:
            # the flux does not depend on the (outgoing) flavour: once
            self.data.link_containers("nu", _ALL_NU)

        for container in self.data:
            e = _host(container["true_energy"])
            cz = np.clip(_host(container["true_coszen"]), -1, 1)
            nu = np.empty((e.size, 2), dtype=FTYPE)
            nubar = np.empty((e.size, 2), dtype=FTYPE)
            nu[:, 0] = calculate_2d_flux_weights(e, cz, self.flux_table["nue"])
            nu[:, 1] = calculate_2d_flux_weights(e, cz, self.flux_table["numu"])
            nubar[:, 0] = calculate_2d_flux_weights(
                e, cz, self.flux_table["nuebar"]
            )
            nubar[:, 1] = calculate_2d_flux_weights(
                e, cz, self.flux_table["numubar"]
            )
            container["nu_flux_nominal"] = nu
            container["nubar_flux_nominal"] = nubar

        self.data.unlink_containers()


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(
                name="flux_table",
                value="flux/honda-2015-spl-solmin-aa.d",
                **param_kwargs,
            )
        ]
    )
    return honda_ip(params=param_set)
