"""
The events-file workflow, as a PISA user turns simulation into an events
file for ``settings/pipeline/example.cfg``:

    per-run simulation files --make_events_file--> events__..._unjoined.hdf5
        --add_fluxes_to_file--> ..._unjoined__with_fluxes_honda-2015-spl-solmin-aa.hdf5
        --> data.simple_data_loader (example.cfg and its variants)

:func:`write_sources` writes the simulation: three runs, one for each
neutrino flavour (12xxx, 14xxx, 16xxx) with its antineutrino, each event
drawn from E^-1 over 1-80 GeV and isotropic in coszen, CC and NC, with a
smeared reconstruction, a PID and a OneWeight, in the nested layout of
:data:`PROC_PARAMS`'s ``field_map`` (``truth/energy``, ``reco/pid``, ...),
written with the port's own HDF5 writer. :func:`run_settings` and
:data:`PROC_PARAMS` are the runs' bookkeeping, in the form of
``tests/test_mc_bookkeeping.py``'s ``RUN_SPEC`` and ``PROC_SPEC``.
:func:`make_example_events_file` runs the two scripts of the workflow on
them; it takes either package's script functions, so that tests can hold
the port's file against the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from pisa_tpu_torch.utils.hdf import to_hdf

__all__ = ["DETECTOR", "PROC_VER", "RUNS", "PROC_PARAMS", "FLUX_TABLE",
           "FLUX_NAME", "run_settings", "write_sources",
           "make_example_events_file"]

DETECTOR = "toydet"
PROC_VER = "5"
#: run -> (neutrino PDG code of its flavour, number of files)
RUNS = {"12600": (12, 10), "14600": (14, 10), "16600": (16, 10)}
FLUX_TABLE = "flux/honda-2015-spl-solmin-aa.d"
FLUX_NAME = "nominal"


def _run_spec(pdg, n_files, n_per_file):
    flav = {12: "nue", 14: "numu", 16: "nutau"}[pdg]
    return {
        "geom": "v36",
        "azimuth_max": "2*pi",
        "azimuth_min": 0,
        "energy_max": 80,
        "energy_min": 1,
        "physical_events_fract": 1.0,
        "genie_prescale_factor": 1.0,
        "flavints": f"{flav},{flav}bar",
        "nu_to_total_fract": 0.5,
        "num_events_per_file": n_per_file,
        "num_i3_files": n_files,
        "sim_spectral_index": 1,
        "xsec_version": "genie_2.8.6",
        "zenith_max": "pi",
        "zenith_min": 0,
    }


def run_settings(n_per_flavint):
    """{detector: {run: settings}}: each run generated 2 * n_per_flavint
    events a sign (the CC and the NC ones drawn)."""
    return {DETECTOR: {
        run: _run_spec(pdg, n_files, 4 * n_per_flavint // n_files)
        for run, (pdg, n_files) in RUNS.items()}}


#: where the fields live in a source file, and the analysis cut
PROC_PARAMS = {
    DETECTOR: {
        PROC_VER: {
            "field_map": {
                "true_energy": "truth/energy",
                "true_zenith": "truth/zenith",
                "reco_energy": "reco/energy",
                "reco_coszen": "reco/coszen",
                "one_weight": "weight/one_weight",
                "nu_code": "truth/nu_code",
                "interaction_type": "truth/int_type",
                "pid": "reco/pid",
            },
            "cuts": {
                "analysis": {
                    "fields": ["reco_energy"],
                    "pass_if": "reco_energy > 2",
                },
            },
        }
    }
}


def _draw_run(rng, pdg, n_per_flavint, n_gen):
    """One run's events: n_per_flavint for each of (nu, nubar) x (CC, NC),
    as {field path parts: array}."""
    parts = []
    for sign in (1, -1):
        for int_type in (1, 2):  # CC, NC
            n = n_per_flavint
            true_e = np.exp(rng.uniform(np.log(1.0), np.log(80.0), n))
            zenith = np.arccos(rng.uniform(-1, 1, n))
            visible = true_e * (0.4 if int_type == 2 else 1.0)
            reco_e = visible * rng.lognormal(0.0, 0.2, n)
            reco_cz = np.clip(
                np.cos(zenith) + rng.normal(0, 0.2 / np.sqrt(visible) + 0.05,
                                            n), -1, 1)
            if abs(pdg) == 14 and int_type == 1:
                pid = rng.uniform(0, 3, n)
            else:
                pid = rng.uniform(-3, 1, n)
            # OneWeight: the effective area (m^2) times the events generated
            aeff = 1e-5 * true_e**2 / (1 + (true_e / 50.0) ** 2)
            parts.append({
                "energy": true_e, "zenith": zenith,
                "nu_code": np.full(n, sign * pdg, dtype=np.int32),
                "int_type": np.full(n, int_type, dtype=np.int32),
                "reco_energy": reco_e, "reco_coszen": reco_cz, "pid": pid,
                "one_weight": aeff * n_gen,
            })
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = rng.permutation(cat["energy"].size)
    return {k: v[order] for k, v in cat.items()}


def write_sources(outdir, n_per_flavint, seed=0, files_per_run=2):
    """Write each run's events, split over `files_per_run` source files;
    returns ``{run: [paths]}`` for ``make_events_file``."""
    rng = np.random.RandomState(seed)
    settings = run_settings(n_per_flavint)[DETECTOR]
    os.makedirs(outdir, exist_ok=True)
    data_files = {}
    for run, (pdg, _) in RUNS.items():
        n_gen = settings[run]["num_events_per_file"] \
            * settings[run]["num_i3_files"] / 2
        ev = _draw_run(rng, pdg, n_per_flavint, n_gen)
        paths = []
        for k, idx in enumerate(np.array_split(np.arange(ev["energy"].size),
                                               files_per_run)):
            tree = {
                "truth": {"energy": ev["energy"][idx],
                          "zenith": ev["zenith"][idx],
                          "nu_code": ev["nu_code"][idx],
                          "int_type": ev["int_type"][idx]},
                "reco": {"energy": ev["reco_energy"][idx],
                         "coszen": ev["reco_coszen"][idx],
                         "pid": ev["pid"][idx]},
                "weight": {"one_weight": ev["one_weight"][idx]},
            }
            path = os.path.join(outdir, f"{DETECTOR}_{run}_{k:02d}.hdf5")
            to_hdf(tree, path)
            paths.append(path)
        data_files[run] = paths
    return data_files


def make_example_events_file(make_events_file, add_fluxes_to_file,
                             load_2d_table, data_files, outdir,
                             n_per_flavint, cut=None, join=None,
                             cust_cuts=None):
    """Run the two scripts (either package's functions) on `data_files`:
    (Events, its file, the file with fluxes)."""
    evts, path = make_events_file(
        data_files=data_files, detector=DETECTOR, proc_ver=PROC_VER,
        cut=cut, outdir=outdir, run_settings=run_settings(n_per_flavint),
        data_proc_params=PROC_PARAMS, join=join, cust_cuts=cust_cuts)
    with_fluxes = add_fluxes_to_file(
        path, load_2d_table(FLUX_TABLE), FLUX_NAME, outdir=outdir,
        label=os.path.splitext(os.path.basename(FLUX_TABLE))[0],
        overwrite=True)
    return evts, path, with_fluxes
