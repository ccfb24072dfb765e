"""
MEOWS HDF5 event loader (counterpart of
``pisa_tpu/stages/data/meows_loader.py``; reference
``pisa/stages/data/meows_loader.py``): loads the MEOWS-format MC (flat HDF5
datasets, PrimaryType PDG selection) into containers with OneWeight-derived
effective areas.

The file is read by the port's own HDF5 reader, and :func:`init_test`
writes its synthetic file with the port's own writer (``utils/hdf.py``), so
neither needs ``h5py``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.hdf import from_hdf, to_hdf
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["meows_loader", "init_test"]

#: the float fields of the synthetic MEOWS file besides PrimaryType
TEST_KEYS = (
    "oneweight", "TotalColumnDepth", "FinalStateX", "FinalStateY",
    "NuEnergy", "NuZenith", "MuExEnergy", "MuExZenith", "pid",
)


class meows_loader(Stage):  # noqa: N801
    """Parameters: events_file (hdf5), n_files, output_names."""

    def __init__(self, events_file, n_files, output_names, **std_kwargs):
        self.events_file = events_file
        self.n_files = int(n_files)
        self.output_names = output_names
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        logging.debug("Loading MEOWS data...")
        raw = from_hdf(find_resource(self.events_file))

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

            mask = np.asarray(raw["PrimaryType"]) == pdg

            def field(key):
                return np.asarray(raw[key])[mask].astype(FTYPE)

            container["weighted_aeff"] = (
                field("oneweight") * 1e-4 / (98000 / 5.0))
            n = int(mask.sum())
            container["weights"] = np.ones(n, dtype=FTYPE)
            container["initial_weights"] = np.ones(n, dtype=FTYPE)
            container["total_column_depth"] = field("TotalColumnDepth")
            container["true_bjorkenx"] = field("FinalStateX")
            container["true_bjorkeny"] = field("FinalStateY")
            container["true_energy"] = field("NuEnergy")
            container["true_coszen"] = np.cos(field("NuZenith"))
            container["reco_energy"] = field("MuExEnergy")
            container["reco_coszen"] = np.cos(field("MuExZenith"))
            container["pid"] = field("pid")
            container.set_aux_data("nubar", nubar)
            container.set_aux_data("flav", flav)
            self.data.add_container(container)

    def apply_function(self):
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0
            container["astro_weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example: the JAX package's synthetic MEOWS file (the
    same draws), written into the temporary directory."""
    rng = np.random.RandomState(0)
    n = 48
    raw = {k: rng.random(n).astype(FTYPE) for k in TEST_KEYS}
    raw["PrimaryType"] = np.array([-12, 14, 12, 16, -14, -16] * 8)
    path = os.path.join(tempfile.gettempdir(),
                        f"pisa_tpu_torch_meows_loader_test_{os.getpid()}.hdf5")
    to_hdf(raw, path)
    return meows_loader(
        events_file=path, n_files=2024, output_names=["nue", "nutau_bar"]
    )
