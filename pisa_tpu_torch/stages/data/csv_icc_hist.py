"""
The atmospheric-muon background histogram (inverted corridor cut) from a
data-release CSV (counterpart of ``pisa_tpu/stages/data/csv_icc_hist.py``;
reference ``pisa/stages/data/csv_icc_hist.py``): each row is a bin count
with an absolute uncertainty, and ``weights = count * atm_muon_scale`` at
every apply. The file is read with bz2 and numpy
(``utils.fileio.read_csv``).

The scale is a free parameter of the release's fit: in a compiled template
its magnitude is a 0-d tensor, or (B, 1) in an evaluation of B lanes, which
gives (B, rows) weights; it enters the data's arithmetic through
``core.stage.in_data_type``.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.fileio import read_csv
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["csv_icc_hist", "init_test"]


class csv_icc_hist(Stage):  # noqa: N801
    """Parameters: events_file; param atm_muon_scale (dimensionless)."""

    def __init__(self, events_file, **std_kwargs):
        self.events_file = find_resource(events_file)
        super().__init__(
            expected_params=("atm_muon_scale",),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        events = read_csv(self.events_file)
        container = Container("icc", representation="events",
                              device=self.data.device)
        container["count"] = events["count"].astype(FTYPE)
        container["weights"] = np.ones(events["count"].size, dtype=FTYPE)
        err_col = "abs_uncert" if "abs_uncert" in events else "abs_uncertainty"
        container["errors"] = events[err_col].astype(FTYPE)
        for key in ("reco_energy", "reco_coszen", "pid"):
            container[key] = events[key].astype(FTYPE)
        self.data.add_container(container)

    def apply_function(self):
        scale = in_data_type(
            self.params.atm_muon_scale.m_as("dimensionless"))
        for container in self.data:
            container["weights"] = container["count"] * scale


def init_test(**param_kwargs):
    """Instantiation example."""
    return csv_icc_hist(
        events_file="events/IceCube_3y_oscillations/muons.csv.bz2",
        params=ParamSet(
            [Param(name="atm_muon_scale", value=0.2, **param_kwargs)]
        ),
    )
