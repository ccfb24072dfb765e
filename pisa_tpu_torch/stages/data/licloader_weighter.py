"""
LeptonWeighter LIC-file weighting (counterpart of
``pisa_tpu/stages/data/licloader_weighter.py``; reference
``pisa/stages/data/licloader_weighter.py``): builds per-event
effective-area weights from LeptonInjector configuration files.

Requires the external ``LeptonWeighter`` package, imported when the service
is built; the stage raises a clear ImportError when it is unavailable
(matching the reference's optional-dependency policy,
``run_unit_tests.py:52``). The events are read with the port's own HDF5
reader (``utils/hdf.py:from_hdf``) and the weights computed on the host at
set-up; the containers are made on the data's device.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.hdf import from_hdf
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["licloader_weighter", "init_test"]


class licloader_weighter(Stage):  # noqa: N801
    """Parameters: in_files (hdf5 events), lic_files, output_names."""

    def __init__(self, in_files, lic_files, output_names, **std_kwargs):
        try:
            import LeptonWeighter as LW  # noqa: N812
        except ImportError as exc:
            raise ImportError(
                "data.licloader_weighter requires the external"
                " 'LeptonWeighter' package, which is not installed in this"
                " environment."
            ) from exc
        self._lw = LW

        if isinstance(lic_files, str):
            lic_files = [lic_files]
        if isinstance(in_files, str):
            in_files = [in_files]
        self.lic_files = [find_resource(f) for f in lic_files]
        self.in_files = [find_resource(f) for f in in_files]
        self.output_names = output_names
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        LW = self._lw
        lic_gens = [LW.MakeGeneratorsFromLICFile(f) for f in self.lic_files]
        xs = LW.CrossSectionFromSpline()
        weighter = LW.Weighter(
            [g for gens in lic_gens for g in gens], xs
        )

        for name in self.output_names:
            container = Container(name, representation="events",
                                  device=self.data.device)
            nubar = -1 if "bar" in name else 1
            if "e" in name:
                flav = 0
            if "mu" in name:
                flav = 1
            if "tau" in name:
                flav = 2
            pdg = nubar * (12 + 2 * flav)

            for f in self.in_files:
                raw = from_hdf(f)
                mask = np.asarray(raw["PrimaryType"]) == pdg
                aeff = np.array(
                    [
                        weighter.get_oneweight(ev)
                        for ev in np.asarray(raw["events"])[mask]
                    ],
                    dtype=FTYPE,
                )
                container["weighted_aeff"] = aeff
                container["true_energy"] = np.asarray(raw["NuEnergy"])[
                    mask
                ].astype(FTYPE)
                container["true_coszen"] = np.cos(
                    np.asarray(raw["NuZenith"])[mask].astype(FTYPE)
                )
            container["weights"] = np.ones(container.size, dtype=FTYPE)
            container["initial_weights"] = np.ones(
                container.size, dtype=FTYPE
            )
            container.set_aux_data("nubar", nubar)
            container.set_aux_data("flav", flav)
            self.data.add_container(container)

    def apply_function(self):
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example (skipped: LeptonWeighter absent)."""
    import pytest

    pytest.importorskip("LeptonWeighter")
