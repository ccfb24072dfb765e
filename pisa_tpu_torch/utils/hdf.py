"""
Recursive dict <-> HDF5 I/O (counterpart of ``pisa_tpu/utils/hdf.py``;
reference ``pisa/utils/hdf.py``): groups map to nested dicts, datasets to
numpy arrays.

:func:`from_hdf` reads through the port's own reader
(``utils/hdf5_reader.py``, numpy and the standard library only), so the
same code runs on machines without ``h5py``; it returns what the JAX
package's ``from_hdf`` returns (h5py's values, a scalar ``bytes`` decoded
to ``str``). :func:`to_hdf` writes through the port's own writer
(``utils/hdf5_writer.py``) what the JAX package's ``to_hdf`` writes through
h5py; neither function imports ``h5py``.
"""

from __future__ import annotations

import os

from pisa_tpu_torch.utils.hdf5_reader import H5File
from pisa_tpu_torch.utils.hdf5_writer import write_hdf5

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


def to_hdf(d, path, attrs=None, overwrite=True):
    """Write a nested dict of arrays to an HDF5 file, with root attributes
    `attrs`."""
    if os.path.exists(path) and not overwrite:
        raise IOError(f"Refusing to overwrite {path}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_hdf5(d, path, attrs=attrs)
