"""
Event loader from SQLite databases (counterpart of
``pisa_tpu/stages/data/sqlite_loader.py``; reference
``pisa/stages/data/sqlite_loader.py``; IceCube Upgrade GNN and retro
reconstructions): reads the truth and reconstruction tables per flavour and
current with the standard library's ``sqlite3`` and pandas, and fills one
container per output name, with effective areas from OneWeight.
"""

from __future__ import annotations

import os
import sqlite3
import tempfile
from contextlib import closing

import numpy as np
import pandas as pd

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["sqlite_loader", "init_test"]

CM2_TO_M2 = 1e-4


class sqlite_loader(Stage):  # noqa: N801
    """Parameters: database (path), output_names, post_fix ('_pred' for the
    GNN, '_retro' for retro)."""

    def __init__(self, database, output_names, post_fix="_pred", **std_kwargs):
        self.database = find_resource(database)
        self.post_fix = post_fix
        self.output_names = output_names
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            **std_kwargs,
        )

    @staticmethod
    def get_pid_and_interaction_type(name):
        """(signed PDG code, interaction type 1 CC / 2 NC, nubar, flavour)
        of a category name."""
        nubar = -1 if "bar" in name else 1
        if "e" in name:
            pid, flavor = 12, 0
        if "mu" in name:
            pid, flavor = 14, 1
        if "tau" in name:
            pid, flavor = 16, 2
        interaction_type = 1 if "cc" in name else 2
        return nubar * pid, interaction_type, nubar, flavor

    def query_database(self, interaction_type, pid):
        """(truth, reco, number of files) of one category, sorted by
        event_no."""
        with closing(sqlite3.connect(self.database)) as con:
            truth = (
                pd.read_sql(
                    "SELECT * FROM truth WHERE interaction_type = ? and"
                    " pid = ?", con, params=(interaction_type, pid))
                .sort_values("event_no")
                .reset_index(drop=True)
            )
            table = "retro" if self.post_fix == "_retro" else "reconstruction"
            event_nos = ",".join(str(int(e)) for e in truth["event_no"])
            reco = (
                pd.read_sql(
                    f"SELECT * FROM {table} WHERE event_no in ({event_nos})",
                    con)
                .sort_values("event_no")
                .reset_index(drop=True)
            )
            n_files = len(pd.read_sql(
                "SELECT DISTINCT RunID, SubrunID FROM truth WHERE pid = ?",
                con, params=(pid,)))
        return truth, reco, n_files

    def setup_function(self):
        for name in self.output_names:
            container = Container(name, representation="events",
                                  device=self.data.device)
            pid, itype, nubar, flavor = self.get_pid_and_interaction_type(
                name)
            truth, reco, n_files = self.query_database(itype, pid)

            container["true_coszen"] = np.cos(
                truth["zenith"]).values.astype(FTYPE)
            container["true_energy"] = truth["energy"].values.astype(FTYPE)
            container.set_aux_data("nubar", nubar)
            container.set_aux_data("flav", flavor)

            container["reco_coszen"] = np.cos(
                reco["zenith" + self.post_fix]).values.astype(FTYPE)
            container["reco_energy"] = reco[
                "energy" + self.post_fix].values.astype(FTYPE)
            pid_column = ("L7_PIDClassifier_FullSky_ProbTrack"
                          if self.post_fix == "_retro"
                          else "track" + self.post_fix)
            container["pid"] = reco[pid_column].values.astype(FTYPE)

            container["weighted_aeff"] = (
                CM2_TO_M2 * truth["OneWeight"] / n_files
                / truth["gen_ratio"] / truth["NEvents"]
            ).values.astype(FTYPE)
            container["weights"] = np.ones(container.size, dtype=FTYPE)
            container["initial_weights"] = np.ones(container.size,
                                                   dtype=FTYPE)
            self.data.add_container(container)

        if len(self.data.names) == 0:
            raise ValueError("no containers created during data loading")

    def apply_function(self):
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def write_test_database(path):
    """The JAX package's synthetic database of ten numu CC events
    (``RandomState(42)``), written to `path`."""
    rng = np.random.RandomState(42)
    n = 10
    true_data, reco_data = [], []
    for i in range(n):
        true_data.append(tuple(rng.random(4).astype(float))
                         + (i, n, 1, 14, 1, 0))
        reco_data.append(tuple(rng.random(3).astype(float)) + (i,))
    with closing(sqlite3.connect(path)) as con, con:
        cur = con.cursor()
        cur.execute(
            "CREATE TABLE truth(energy, zenith, OneWeight, gen_ratio,"
            " event_no, NEvents, interaction_type, pid, RunID, SubrunID)")
        cur.executemany(
            "INSERT INTO truth VALUES(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            true_data)
        cur.execute(
            "CREATE TABLE reconstruction(energy_pred, zenith_pred,"
            " track_pred, event_no)")
        cur.executemany("INSERT INTO reconstruction VALUES(?, ?, ?, ?)",
                        reco_data)


def init_test(**param_kwargs):
    """Instantiation example: the JAX package's synthetic database, written
    into the temporary directory."""
    path = os.path.join(tempfile.gettempdir(),
                        f"pisa_tpu_torch_sqlite_loader_test_{os.getpid()}")
    if not os.path.isfile(path):
        write_test_database(path)
    return sqlite_loader(database=path, output_names=["numu_cc"])
