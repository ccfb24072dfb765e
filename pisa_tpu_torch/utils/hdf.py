"""
Recursive dict <-> HDF5 I/O (counterpart of ``pisa_tpu/utils/hdf.py``;
reference ``pisa/utils/hdf.py``): groups map to nested dicts, datasets to
numpy arrays.

:func:`from_hdf` reads through the port's own reader
(``utils/hdf5_reader.py``, numpy and the standard library only), so the
same code runs on machines without ``h5py``; it returns what the JAX
package's ``from_hdf`` returns (h5py's values, a scalar ``bytes`` decoded
to ``str``). :func:`to_hdf` writes with ``h5py`` and raises an
``ImportError`` naming it where it is missing.
"""

from __future__ import annotations

import os

import numpy as np

from pisa_tpu_torch.utils.hdf5_reader import H5File

__all__ = ["from_hdf", "to_hdf"]


def _decode(tree):
    if isinstance(tree, dict):
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, bytes):
        return tree.decode()
    return tree


def from_hdf(path, choose=None):
    """Read an HDF5 file into a nested dict of arrays; `choose` keeps only
    the named datasets at the file's top level."""
    with H5File(os.path.expandvars(os.path.expanduser(path))) as f:
        return _decode(f.read("/", choose=choose))


def _write_group(h5py, group, d):
    for key, val in d.items():
        key = str(key)
        if isinstance(val, dict):
            _write_group(h5py, group.create_group(key), val)
        else:
            arr = np.asarray(val)
            if arr.dtype.kind in ("U", "O"):
                arr = arr.astype(h5py.string_dtype())
            group.create_dataset(key, data=arr)


def to_hdf(d, path, attrs=None, overwrite=True):
    """Write a nested dict of arrays to an HDF5 file (needs ``h5py``)."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "to_hdf needs the h5py package, which is not installed; reading"
            " (from_hdf) does not"
        ) from exc
    if os.path.exists(path) and not overwrite:
        raise IOError(f"Refusing to overwrite {path}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        _write_group(h5py, f, d)
        for k, v in (attrs or {}).items():
            f.attrs[k] = v
