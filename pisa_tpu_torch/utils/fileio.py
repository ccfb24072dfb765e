"""
Host copy of ``pisa_tpu/utils/fileio.py`` with its imports rewritten to
``pisa_tpu_torch``. CSV files are read with numpy (plain or ``.bz2``
compressed) into ``{column: array}`` dicts; HDF5 files are read and
written by the port's own reader and writer (``utils/hdf.py``), without
``h5py``.

Generic file I/O dispatch by extension (cf. reference
``pisa/utils/fileio.py:486,542``): .json(.bz2), .csv(.bz2), .pkl,
.hdf5/.h5/.hdf, .dat/.txt (whitespace tables).
"""

from __future__ import annotations

import bz2
import io
import os
import pickle

import numpy as np

from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["from_file", "to_file", "expand", "read_csv"]


def expand(path):
    return os.path.expanduser(os.path.expandvars(path))


def read_csv(fname):
    """Numeric CSV with a header row -> ``{column: float64 array}``, in the
    file's column order. ``.bz2`` files are decompressed on the fly. An
    empty field reads as NaN (pandas writes NaN so)."""
    path = find_resource(fname)
    opener = bz2.open if path.endswith(".bz2") else open
    with opener(path, "rt") as f:
        header = f.readline().strip().split(",")
        body = f.read()
    try:
        table = np.loadtxt(
            io.StringIO(body), delimiter=",", dtype=np.float64, ndmin=2
        )
    except ValueError:
        table = np.atleast_2d(np.genfromtxt(
            io.StringIO(body), delimiter=",", dtype=np.float64,
            filling_values=np.nan))
    if table.shape[1] != len(header):
        raise ValueError(
            f"{fname}: {table.shape[1]} columns under a header of"
            f" {len(header)}"
        )
    return {name: table[:, i] for i, name in enumerate(header)}


def from_file(fname, fmt=None, **kwargs):
    """Load a file based on its extension."""
    path = find_resource(fname)
    ext = (fmt or os.path.splitext(path.replace(".bz2", ""))[1][1:]).lower()

    if ext == "json":
        from pisa_tpu_torch.utils.jsons import from_json

        return from_json(path)
    if ext == "csv":
        return read_csv(path)
    if ext in ("pkl", "pckl", "pickle"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if ext in ("hdf5", "h5", "hdf"):
        from pisa_tpu_torch.utils.hdf import from_hdf

        return from_hdf(path, **kwargs)
    if ext in ("dat", "txt"):
        return np.loadtxt(path, **kwargs)
    raise ValueError(f"Unhandled extension {ext!r} for file {fname!r}")


def to_file(obj, fname, fmt=None, **kwargs):
    """Write `obj` based on the target extension."""
    path = expand(fname)
    ext = (fmt or os.path.splitext(path.replace(".bz2", ""))[1][1:]).lower()
    if ext == "json":
        from pisa_tpu_torch.utils.jsons import to_json

        return to_json(obj, path, **kwargs)
    if ext in ("pkl", "pckl", "pickle"):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=4)
        return None
    if ext in ("hdf5", "h5", "hdf"):
        from pisa_tpu_torch.utils.hdf import to_hdf

        return to_hdf(obj, path, **kwargs)
    raise ValueError(f"Unhandled extension {ext!r} for file {fname!r}")
