"""
PISA-format HDF5 event loader (counterpart of
``pisa_tpu/stages/data/simple_data_loader.py``; reference
``pisa/stages/data/simple_data_loader.py:36``): loads events through
:class:`pisa_tpu_torch.core.events_pi.EventsPi` (HDF5 files read by the
port's own reader, so no ``h5py`` is needed), applies the MC cuts and the
variable mapping, and fills one container per flavint category, on the
pipeline's device, with nominal weights and the flavour aux data.

``events_file`` is a path, a comma-separated string of paths, a sequence of
them, or an already-loaded mapping (e.g. ``scripts/make_toy_events.py``'s
output), as for the JAX stage.
"""

from __future__ import annotations

import ast
from collections.abc import Mapping

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.events_pi import EventsPi
from pisa_tpu_torch.core.stage import Stage

__all__ = ["simple_data_loader", "init_test"]


class simple_data_loader(Stage):  # noqa: N801
    """Parameters
    ----------
    events_file : str, comma-separated str, sequence, or mapping
    mc_cuts : str or None
    data_dict : dict or str (python-literal dict): dst -> src (or list)
    neutrinos : bool
    fraction_events_to_keep, events_subsample_index, seed : down-sampling
    output_names : categories to load
    """

    # the apply is pure per-event array math (weights = initial_weights),
    # shape-agnostic over the (C, n_pad) category-stacked layout
    supports_stacked = True

    def __init__(
        self,
        events_file,
        mc_cuts,
        data_dict,
        neutrinos=True,
        required_metadata=None,
        fraction_events_to_keep=None,
        events_subsample_index=0,
        seed=123456,
        output_names=None,
        **std_kwargs,
    ):
        if isinstance(events_file, str):
            events_file = [s.strip() for s in events_file.split(",")]
        elif isinstance(events_file, Mapping):
            events_file = [events_file]
        self.events_file = events_file
        self.mc_cuts = mc_cuts
        if isinstance(data_dict, str):
            data_dict = ast.literal_eval(data_dict)
        self.data_dict = data_dict
        self.neutrinos = neutrinos
        if isinstance(required_metadata, str):
            required_metadata = [
                s.strip() for s in required_metadata.split(",")
            ]
        self.required_metadata = required_metadata
        self.fraction_events_to_keep = fraction_events_to_keep
        self.events_subsample_index = int(events_subsample_index)
        self.seed = int(seed)
        self.output_names = output_names or []

        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )
        if len(self.output_names) != len(set(self.output_names)):
            raise ValueError("duplicate entries in output_names")

        self.load_events()
        self.apply_cuts_to_events()

    def load_events(self):
        self.evts = EventsPi(
            name="Events",
            neutrinos=self.neutrinos,
            fraction_events_to_keep=self.fraction_events_to_keep,
            events_subsample_index=self.events_subsample_index,
        )
        self.evts.load_events_file(
            events_file=self.events_file,
            variable_mapping=self.data_dict,
            required_metadata=self.required_metadata,
            seed=self.seed,
        )
        self.metadata = self.evts.metadata

    def apply_cuts_to_events(self):
        if self.mc_cuts:
            self.evts = self.evts.apply_cut(self.mc_cuts)

    def setup_function(self):
        output_keys = (
            self.output_names if self.output_names else list(self.evts.keys())
        )
        for name in output_keys:
            if name not in self.evts:
                raise ValueError(
                    f"output name {name!r} not in events"
                    f" (have {list(self.evts.keys())})"
                )
            container = Container(name, representation="events",
                                  device=self.data.device)
            for key, val in self.evts[name].items():
                container[key] = val

            if "weights" in container.keys:
                raise KeyError(
                    f"existing 'weights' array in {name!r} would be"
                    " overwritten; rename it to 'initial_weights'"
                )
            container["weights"] = np.ones(container.size, dtype=FTYPE)
            if "initial_weights" not in container.keys:
                if self.fraction_events_to_keep is None:
                    init = np.ones(container.size, dtype=FTYPE)
                elif "nu" in name or "mu" in name:
                    init = np.full(
                        container.size,
                        1.0 / float(self.fraction_events_to_keep),
                        dtype=FTYPE,
                    )
                else:
                    init = np.ones(container.size, dtype=FTYPE)
                container["initial_weights"] = init

            if self.neutrinos:
                nubar = -1 if "bar" in name else 1
                if name.startswith("nutau"):
                    flav = 2
                elif name.startswith("numu"):
                    flav = 1
                elif name.startswith("nue"):
                    flav = 0
                else:
                    raise ValueError(f"cannot determine flavor of {name!r}")
                container.set_aux_data("nubar", nubar)
                container.set_aux_data("flav", flav)

            self.data.add_container(container)

        if len(self.data.names) == 0:
            raise ValueError("no containers created during data loading")

    def apply_function(self):
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example (the JAX stage's)."""
    return simple_data_loader(
        events_file=(
            "events/events__vlvnt__toy_1_to_80GeV_spidx1.0_cz-1_to_1_1e2evts"
            "_set0__unjoined__with_fluxes_honda-2015-spl-solmin-aa.hdf5"
        ),
        mc_cuts="(true_coszen <= 0.5) & (true_energy <= 70)",
        data_dict={
            "true_energy": "true_energy",
            "true_coszen": "true_coszen",
            "reco_energy": "reco_energy",
            "reco_coszen": "reco_coszen",
            "pid": "pid",
            "weighted_aeff": "weighted_aeff",
            "nu_flux_nominal": ["nominal_nue_flux", "nominal_numu_flux"],
            "nubar_flux_nominal": [
                "nominal_nuebar_flux", "nominal_numubar_flux",
            ],
        },
        output_names=[
            "nue_cc", "numu_cc", "nutau_cc", "nuebar_cc", "numubar_cc",
            "nutaubar_cc", "nue_nc", "numu_nc", "nutau_nc", "nuebar_nc",
            "numubar_nc", "nutaubar_nc",
        ],
    )
