"""
Host copy of ``pisa_tpu/scripts/make_events_file.py`` with its imports
rewritten to ``pisa_tpu_torch``: the source files are read and the events
file is written by the port's own HDF5 reader and writer
(``utils/hdf5_reader.py``, ``utils/hdf5_writer.py``), without ``h5py``.

Generate a PISA-standard events file from simulation HDF5 files
(cf. reference ``pisa/scripts/make_events_file.py:100`` ``makeEventsFile``).

Takes per-run source HDF5 files (fields located via
:class:`~pisa_tpu_torch.utils.data_proc_params.DataProcParams`), applies the
named + custom cuts, splits events into flavints, computes the
``weighted_aeff`` field, and writes an :class:`~pisa_tpu_torch.core.events.Events`
file.

``weighted_aeff`` (reference docstring, ``make_events_file.py:166-190``):
each event's ``one_weight`` is divided by the TOTAL number of events
generated with its interaction type within its (possibly joined) flavor
grouping, summed over all runs contributing that flavor — so joined groups'
effective areas come out as the ngen-weighted average of the members.
"""

from __future__ import annotations

import os

import numpy as np

from pisa_tpu_torch.core.events import Events
from pisa_tpu_torch.utils.data_proc_params import DataProcParams
from pisa_tpu_torch.utils.flavint import (
    ALL_NUFLAVINTS,
    NuFlavIntGroup,
    flavint_groups_from_string,
)
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.mc_sim_run_settings import DetMCSimRunsSettings

__all__ = ["make_events_file", "powerlaw_integral"]

EXTRACT_FIELDS = (
    "true_energy",
    "true_coszen",
    "reco_energy",
    "reco_coszen",
    "one_weight",
    "interaction_type",
    "nu_code",
    "pid",
)

OUTPUT_FIELDS = (
    "true_energy",
    "true_coszen",
    "reco_energy",
    "reco_coszen",
    "one_weight",
    "weighted_aeff",
    "pid",
)


def powerlaw_integral(e0, e1, gamma):
    """Integral of E^-gamma over [e0, e1] (reference
    ``make_events_file.py:93``)."""
    if gamma == 1:
        return np.log(e1) - np.log(e0)
    num = e1 ** (1.0 - gamma) - e0 ** (1.0 - gamma)
    return num / (1.0 - gamma)


def make_events_file(
    data_files,
    detector,
    proc_ver,
    cut,
    outdir,
    run_settings=None,
    data_proc_params=None,
    join=None,
    cust_cuts=None,
    extract_fields=EXTRACT_FIELDS,
    output_fields=OUTPUT_FIELDS,
):
    """Build and write the PISA events file; returns (Events, outpath)
    (cf. reference ``makeEventsFile``, ``make_events_file.py:100``).

    Parameters
    ----------
    data_files : dict {run: list of source HDF5 paths}
    detector, proc_ver : keys into run-settings / proc-params specs
    cut : named cut from the proc params (or None)
    outdir : output directory
    run_settings : DetMCSimRunsSettings or spec path/dict
    data_proc_params : DataProcParams or spec path/dict
    join : flavint-grouping string, e.g. 'numu_cc+numubar_cc; nuall_nc'
    cust_cuts : extra cut spec dict(s) ({'fields': [...], 'pass_if': ...})
    """
    if not isinstance(run_settings, DetMCSimRunsSettings):
        run_settings = DetMCSimRunsSettings(run_settings, detector=detector)
    if not isinstance(data_proc_params, DataProcParams):
        data_proc_params = DataProcParams(
            detector=detector, proc_ver=proc_ver,
            data_proc_params=data_proc_params,
        )

    runs = sorted(data_files.keys())
    detector_geom = run_settings[runs[0]].get("geom", "")

    evts = Events()
    evts.metadata.update(
        {
            "detector": detector,
            "proc_ver": str(proc_ver),
            "geom": detector_geom,
            "runs": list(runs),
        }
    )

    cuts = []
    if isinstance(cust_cuts, dict):
        cust_cuts = [cust_cuts]
    if cut is not None:
        evts.metadata["cuts"].append(cut)
        cuts.append(cut)
    for ccut in cust_cuts or ():
        evts.metadata["cuts"].append("custom: " + ccut["pass_if"])
        cuts.append(ccut)

    # flavint groupings: joined groups + singletons for the rest
    if join:
        grouped = flavint_groups_from_string(join)
        # the catch-all appended by the parser becomes singletons
        explicit = [NuFlavIntGroup(s) for s in join.split(";") if s.strip()]
        covered = {fi for g in explicit for fi in g}
        groupings = explicit + [
            NuFlavIntGroup(fi) for fi in ALL_NUFLAVINTS if fi not in covered
        ]
        evts.metadata["flavints_joined"] = [str(g) for g in explicit]
        del grouped
    else:
        groupings = [NuFlavIntGroup(fi) for fi in ALL_NUFLAVINTS]

    # -- extract all runs once -------------------------------------------------
    per_run_data = {}
    for run in runs:
        parts = []
        for path in data_files[run]:
            data = data_proc_params.get_data(path, run_settings=run_settings)
            if extract_fields:
                data = {
                    k: v for k, v in data.items()
                    if k in set(extract_fields) | {"nu_code",
                                                   "interaction_type"}
                }
            parts.append(data)
        fields = set(parts[0].keys())
        for p in parts[1:]:
            fields &= set(p.keys())
        merged = {
            f: np.concatenate([np.asarray(p[f]) for p in parts])
            for f in fields
        }
        if cuts:
            merged = data_proc_params.apply_cuts(merged, cuts)
        per_run_data[run] = merged

    # -- split into flavints, compute weighted_aeff per grouping ----------------
    for group in groupings:
        for int_type in ("cc", "nc"):
            flavints = [fi for fi in group if str(fi.int_type) == int_type]
            if not flavints:
                continue
            # ngen for this (group, int type): sum over runs and over the
            # group's flavors present in each run (generation counts are
            # per flavor; interaction types share the flavor's generation)
            ngen = 0.0
            for run in runs:
                rs = run_settings[run]
                for flav in {fi.flav for fi in flavints}:
                    if flav in rs.get_flavs():
                        ngen += rs.get_num_gen(
                            flav_or_flavint=str(flav),
                            include_physical_fract=True,
                        )
            if ngen == 0:
                logging.warning(
                    "no generated events for %s %s; skipping",
                    group, int_type,
                )
                continue
            # pool ALL the group's flavors (this int type) into one sample
            # and store it under EVERY member flavint — the reference's
            # joined-group convention (Events.histogram reads one
            # representative member, expecting it to hold the whole group;
            # weighted_aeff is normalized by the pooled ngen accordingly)
            group_codes = sorted({fi.flav.code for fi in flavints})
            code_cut = " | ".join(f"(nu_code == {c})" for c in group_codes)
            sel_parts = []
            for run in runs:
                data = per_run_data[run]
                run_flavs = {f.code for f in run_settings[run].get_flavs()}
                if not run_flavs & set(group_codes):
                    continue
                sel = data_proc_params.apply_cuts(
                    data,
                    [
                        {"fields": ["nu_code"], "pass_if": code_cut},
                        str(int_type),
                    ],
                )
                sel_parts.append(sel)
            if not sel_parts:
                continue
            fields = set(sel_parts[0].keys())
            for p in sel_parts[1:]:
                fields &= set(p.keys())
            merged = {
                f: np.concatenate([np.asarray(p[f]) for p in sel_parts])
                for f in fields
            }
            merged["weighted_aeff"] = (
                np.asarray(merged["one_weight"], dtype=np.float64) / ngen
            )
            if output_fields:
                merged = {
                    k: v for k, v in merged.items() if k in output_fields
                }
            for fi in flavints:
                evts[fi] = merged

    evts.update_hash()

    # -- write ------------------------------------------------------------------
    os.makedirs(outdir, exist_ok=True)
    join_label = (
        "joined_G_" + "_G_".join(evts.metadata["flavints_joined"])
        if evts.metadata["flavints_joined"]
        else "unjoined"
    )
    fname = (
        f"events__{detector}__proc_{proc_ver}__{join_label}.hdf5"
    ).replace(" ", "_").replace(";", "_")
    outpath = os.path.join(outdir, fname)
    evts.save(outpath)
    logging.info("Wrote events file to %s", outpath)
    return evts, outpath


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "--det", required=True, help="detector name (spec key)"
    )
    parser.add_argument("--proc", required=True, help="processing version")
    parser.add_argument(
        "--run", action="append", nargs="+", metavar=("RUN", "FILE"),
        required=True,
        help="run number followed by its source HDF5 file path(s); repeat"
        " per run",
    )
    parser.add_argument("--run-settings", required=True)
    parser.add_argument("--data-proc-params", required=True)
    parser.add_argument("--cut", default=None)
    parser.add_argument(
        "--join", default=None,
        help="flavints to join, e.g. 'numu_cc+numubar_cc; nuall_nc'",
    )
    parser.add_argument("--outdir", required=True)
    args = parser.parse_args(argv)

    data_files = {r[0]: list(r[1:]) for r in args.run}
    make_events_file(
        data_files=data_files,
        detector=args.det,
        proc_ver=args.proc,
        cut=args.cut,
        outdir=args.outdir,
        run_settings=args.run_settings,
        data_proc_params=args.data_proc_params,
        join=args.join,
    )


if __name__ == "__main__":
    main()
