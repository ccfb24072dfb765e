"""
Host copy of ``pisa_tpu/scripts/add_flux_to_events_file.py`` with its
imports rewritten to ``pisa_tpu_torch``: the fluxes come from the port's
``utils/flux_weights.py``, and the file is read and written without
``h5py`` (``utils/hdf.py``).

Add atmospheric-flux columns to a PISA events HDF5 file (cf. reference
``pisa/scripts/add_flux_to_events_file.py:38`` ``add_fluxes_to_file``):
for every neutrino category, evaluate the 2-D integral-preserving flux
splines at the events' (true_energy, true_coszen) and store
``<flux_name>_{nue,nuebar,numu,numubar}_flux`` fields, writing a copy of
the file with ``__with_fluxes`` appended to its name.
"""

from __future__ import annotations

import os
from os.path import basename, dirname, isfile, join, splitext

from pisa_tpu_torch.utils.fileio import from_file, to_file
from pisa_tpu_torch.utils.flux_weights import (
    calculate_2d_flux_weights,
    load_2d_table,
)
from pisa_tpu_torch.utils.log import logging, set_verbosity
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["add_fluxes_to_file"]

FLAV_TABLES = ("nue", "nuebar", "numu", "numubar")


def add_fluxes_to_file(
    data_file_path, flux_table, flux_name, outdir=None, label=None,
    overwrite=False,
):
    """Evaluate and attach nominal fluxes to every neutrino category of a
    PISA events file; returns the output path (cf. reference
    ``add_flux_to_events_file.py:38``)."""
    data = from_file(find_resource(data_file_path))
    bname, ext = splitext(basename(data_file_path))

    if outdir is None:
        outdir = dirname(data_file_path) or "."
    label = "" if label is None else f"_{label}"
    outpath = join(outdir, f"{bname}__with_fluxes{label}{ext}")
    if not overwrite and isfile(outpath):
        logging.warning(
            "Output path %r already exists, not regenerating", outpath
        )
        return outpath
    os.makedirs(outdir, exist_ok=True)

    for primary, node in data.items():
        if not str(primary).startswith("nu"):
            continue  # skip muons/noise/metadata
        # either {category: fields} or older {flav: {int: fields}}
        secondary = [node] if "true_energy" in node else list(node.values())
        for fields in secondary:
            e = fields["true_energy"]
            cz = fields["true_coszen"]
            for table in FLAV_TABLES:
                fields[f"{flux_name}_{table}_flux"] = (
                    calculate_2d_flux_weights(e, cz, flux_table[table])
                )
        logging.info("Added fluxes to %r events", primary)

    to_file(data, outpath)
    logging.info("Wrote file including fluxes to %r", outpath)
    return outpath


def main(argv=None):
    from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "--input", nargs="+", required=True,
        help="PISA events HDF5 file(s) or directory of them",
    )
    parser.add_argument(
        "--flux-file", required=True,
        help="flux table, e.g. flux/honda-2015-spl-solmin-aa.d",
    )
    parser.add_argument("--outdir", default=None)
    parser.add_argument(
        "--label", default=None,
        help="output label (default: flux file basename)",
    )
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("-v", action="count", default=1)
    args = parser.parse_args(argv)
    set_verbosity(args.v)

    flux_table = load_2d_table(args.flux_file)
    flux_name = "nominal"
    label = (
        args.label
        if args.label is not None
        else splitext(basename(args.flux_file))[0]
    )

    paths = []
    for inp in args.input:
        if os.path.isdir(inp):
            paths.extend(
                join(inp, f) for f in sorted(os.listdir(inp))
                if f.endswith((".hdf5", ".h5", ".hdf"))
            )
        else:
            paths.append(inp)
    for path in paths:
        add_fluxes_to_file(
            path, flux_table=flux_table, flux_name=flux_name,
            outdir=args.outdir, label=label, overwrite=args.overwrite,
        )


if __name__ == "__main__":
    main()
