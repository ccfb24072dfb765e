"""
Event loader for IceCube data-release CSV files (counterpart of
``pisa_tpu/stages/data/csv_loader.py``; reference
``pisa/stages/data/csv_loader.py``): one container per requested neutrino
category, selected from the file by PDG code and current type.

Reads ``.csv``/``.csv.bz2`` with bz2 and numpy (``utils.fileio.read_csv``).
"""

from __future__ import annotations

import ast

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.fileio import read_csv
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["csv_loader", "init_test"]


class csv_loader(Stage):  # noqa: N801
    """CSV data-release event loader.

    Parameters
    ----------
    events_file : str or sequence of str
        csv file path(s); comma-separated string allowed.
    data_dict : dict or str (python-literal dict)
        container key -> csv column (or list of columns, stacked to 2-D).
    output_names : sequence of str
        neutrino categories ('nue_cc', 'numubar_nc', ...), selected by PDG
        code and current type; any names with ``neutrinos=False``.
    neutrinos : bool
        select events by PDG code and current type per category (else every
        container takes every event, and gets no nubar/flav aux data).
    dis_idx : int, optional
        the value of the 'interaction' key that marks DIS events: fills the
        'dis' key (1 for DIS, 0 else) for the DIS systematics stage.
    scale_aeff : bool
        convert weighted_aeff from cm^2 to m^2 (x 1e-4).
    fraction_events_to_keep : float in (0, 1], optional
        keep this fraction of each category's events, by a deterministic
        stride (the JAX package's option, for fast tests).
    """

    def __init__(self, events_file, data_dict, output_names, neutrinos=True,
                 dis_idx=None, scale_aeff=False, fraction_events_to_keep=None,
                 **std_kwargs):
        self.fraction_events_to_keep = (
            None if fraction_events_to_keep is None
            else float(fraction_events_to_keep))
        if self.fraction_events_to_keep is not None and not (
                0.0 < self.fraction_events_to_keep <= 1.0):
            raise ValueError("fraction_events_to_keep must be in (0, 1]")
        self.neutrinos = neutrinos
        self.dis_idx = None if dis_idx is None else int(dis_idx)
        self.scale_aeff = scale_aeff
        if isinstance(events_file, str):
            events_file = [s.strip() for s in events_file.split(",")]
        self.events_file = [find_resource(f) for f in events_file]

        if isinstance(data_dict, str):
            data_dict = ast.literal_eval(data_dict)
        if not isinstance(data_dict, dict):
            raise ValueError(f"unsupported data_dict type {type(data_dict)}")
        self.data_dict = data_dict

        if len(output_names) != len(set(output_names)):
            raise ValueError("duplicate entries in output_names")
        self.output_names = output_names

        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    def _read(self):
        tables = [read_csv(f) for f in self.events_file]
        columns = list(tables[0])
        for t in tables[1:]:
            if list(t) != columns:
                raise ValueError("events files have different columns")
        return {c: np.concatenate([t[c] for t in tables]) for c in columns}

    def _rows(self, raw, name, container):
        """The rows of `raw` for the category `name` (every row without
        ``neutrinos``), with its aux data set on `container`."""
        if not self.neutrinos:
            return np.arange(len(next(iter(raw.values()))))
        nubar = -1 if "bar" in name else 1
        if "e" in name:
            flav = 0
        if "mu" in name:
            flav = 1
        if "tau" in name:
            flav = 2
        container.set_aux_data("nubar", nubar)
        container.set_aux_data("flav", flav)
        if "pdg_code" in raw:
            pdg_codes = raw["pdg_code"]
        elif "pdg" in raw:
            pdg_codes = raw["pdg"]
        else:
            raise ValueError("either 'pdg' or 'pdg_code' must be in the file")
        mask = pdg_codes == nubar * (12 + 2 * flav)
        if "cc" in name:
            mask &= raw["type"] >= 1
        else:
            mask &= raw["type"] == 0
        return np.flatnonzero(mask)

    def setup_function(self):
        raw = self._read()
        for name in self.output_names:
            container = Container(name, representation="events",
                                  device=self.data.device)
            rows = self._rows(raw, name, container)
            if self.fraction_events_to_keep is not None:
                n_keep = max(1, int(round(self.fraction_events_to_keep
                                          * rows.size)))
                rows = rows[::max(1, rows.size // n_keep)][:n_keep]

            container["initial_weights"] = np.ones(rows.size, dtype=FTYPE)
            container["weights"] = np.ones(rows.size, dtype=FTYPE)
            values = {}
            for key, col in self.data_dict.items():
                if isinstance(col, (list, tuple)):
                    values[key] = np.stack(
                        [raw[c][rows].astype(FTYPE) for c in col], axis=1
                    )
                else:
                    values[key] = raw[col][rows].astype(FTYPE)
            if self.scale_aeff and "weighted_aeff" in values:
                values["weighted_aeff"] = values["weighted_aeff"] * FTYPE(1e-4)
            if ("dis" not in values and "interaction" in values
                    and self.dis_idx is not None):
                values["dis"] = (values["interaction"] == self.dis_idx
                                 ).astype(FTYPE)
            for key, value in values.items():
                container[key] = value
            self.data.add_container(container)

        if len(self.data.names) == 0:
            raise ValueError("no containers created during data loading")

    def apply_function(self):
        # reset weights before downstream stages multiply them
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example."""
    data_dict = {
        "true_energy": "true_energy",
        "true_coszen": "true_coszen",
        "weighted_aeff": "weight",
        "reco_energy": "reco_energy",
        "reco_coszen": "reco_coszen",
        "pid": "pid",
    }
    return csv_loader(
        events_file="events/IceCube_3y_oscillations/neutrino_mc.csv.bz2",
        data_dict=data_dict,
        output_names=["nue_cc", "numu_cc"],
    )
