"""
Host copy of ``pisa_tpu/scripts/make_nufit_theta23_spline_priors.py`` with
its imports rewritten to ``pisa_tpu_torch``.

Build theta23 spline priors from NuFit delta-chi2 surface releases
(cf. reference ``pisa/scripts/make_nufit_theta23_spline_priors.py``).

Reads the gzipped NuFit chi2 release files (one per mass ordering),
extracts the 1-d sin^2(theta23) Delta-chi2 projection, fits a cubic
B-spline to llh = -Delta-chi2/2 over theta23 (radians), and writes
prior JSON files in the format consumed by
:class:`pisa_tpu_torch.core.prior.Prior` (kind='spline'): 'standard' per
ordering, plus optional 'shifted' (each ordering's surface floored to its
own minimum) and 'minimised' (pointwise minimum over orderings) variants
that remove the implicit mass-ordering prior.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import scipy.interpolate

from pisa_tpu_torch.utils.fileio import to_file

__all__ = ["extract_vals", "make_prior_dict", "build_spline_priors"]

T23_SECTION = "# T23 projection: sin^2(theta23) Delta_chi^2"


def extract_vals(infile, string_of_interest):
    """(x, y) columns of the section headed by `string_of_interest` in a
    NuFit release file (reference ``make_nufit_theta23_spline_priors.py:39``)."""
    readout = False
    x, y = [], []
    for line in infile:
        if isinstance(line, bytes):
            line = line.decode()
        stripped = line.strip()
        if stripped.startswith("#"):
            readout = stripped == string_of_interest
            continue
        if readout:
            vals = stripped.split()
            if len(vals) == 2:
                x.append(float(vals[0]))
                y.append(float(vals[1]))
    return x, y


def _spline_entry(tck):
    knots, coeffs, deg = tck
    return {
        "knots": np.asarray(knots),
        "coeffs": np.asarray(coeffs),
        "deg": int(deg),
        "kind": "spline",
        "units": "radian",
    }


def make_prior_dict(f_io=None, f_no=None, f=None):
    """Prior-file dict from splrep tck tuples: either one ordering-agnostic
    spline (`f`) or one per ordering (reference :59)."""
    if f is not None:
        return {"theta23": _spline_entry(f)}
    if f_io is not None and f_no is not None:
        return {
            "theta23_ih": _spline_entry(f_io),
            "theta23_nh": _spline_entry(f_no),
        }
    raise ValueError("No functions passed to save!")


def _read_t23_surface(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fl:
        s2t23, dchi2 = extract_vals(fl, T23_SECTION)
    if not s2t23:
        raise ValueError(f"no T23 projection section found in {path}")
    th23 = np.arcsin(np.sqrt(np.asarray(s2t23)))
    return th23, np.asarray(dchi2)


def build_spline_priors(
    io_chi2_file, no_chi2_file, outdir, version=None, shifted=False,
    minimised=False,
):
    """Create the prior JSON file(s); returns the list of written paths."""
    if version is None:
        version = os.path.basename(io_chi2_file).split(".")[0]
    io_th23, io_dchi2 = _read_t23_surface(io_chi2_file)
    no_th23, no_dchi2 = _read_t23_surface(no_chi2_file)

    os.makedirs(outdir, exist_ok=True)
    written = []

    f_io = scipy.interpolate.splrep(io_th23, -io_dchi2 / 2.0, s=0)
    f_no = scipy.interpolate.splrep(no_th23, -no_dchi2 / 2.0, s=0)
    path = os.path.join(
        outdir, f"nufit{version}standardtheta23splines.json"
    )
    to_file(make_prior_dict(f_io=f_io, f_no=f_no), path)
    written.append(path)

    if shifted:
        f_sio = scipy.interpolate.splrep(
            io_th23, -(io_dchi2 - io_dchi2.min()) / 2.0, s=0
        )
        f_sno = scipy.interpolate.splrep(
            no_th23, -(no_dchi2 - no_dchi2.min()) / 2.0, s=0
        )
        path = os.path.join(
            outdir, f"nufit{version}shiftedtheta23splines.json"
        )
        to_file(make_prior_dict(f_io=f_sio, f_no=f_sno), path)
        written.append(path)

    if minimised:
        minchi2 = np.minimum(io_dchi2, no_dchi2)
        f_min = scipy.interpolate.splrep(io_th23, -minchi2 / 2.0, s=0)
        path = os.path.join(
            outdir, f"nufit{version}minimisedtheta23spline.json"
        )
        to_file(make_prior_dict(f=f_min), path)
        written.append(path)

    return written


def main(argv=None):
    from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "-io", "--io-chi2-file", required=True,
        help="Inverted-ordering chi2 release file from NuFit (.gz)",
    )
    parser.add_argument(
        "-no", "--no-chi2-file", required=True,
        help="Normal-ordering chi2 release file from NuFit (.gz)",
    )
    parser.add_argument("--shifted", action="store_true")
    parser.add_argument("--minimised", action="store_true")
    parser.add_argument("--version", default=None)
    parser.add_argument("--outdir", required=True)
    args = parser.parse_args(argv)
    for path in build_spline_priors(
        args.io_chi2_file, args.no_chi2_file, args.outdir,
        version=args.version, shifted=args.shifted,
        minimised=args.minimised,
    ):
        print(path)


if __name__ == "__main__":
    main()
