"""
Host copy of ``pisa_tpu/utils/hdfchain.py`` with its imports rewritten to
``pisa_tpu_torch``, on the port's own HDF5 reader
(``utils/hdf5_reader.py``) instead of ``h5py``.

Chained access to a set of HDF5 files holding same-schema tables
(cf. reference ``pisa/utils/hdfchain.py``: ``HDFChain`` / ``HDFTableProxy``
/ ``TableAccessor``). Reading a table path concatenates that dataset across
every file in the chain, in order; files missing the node contribute zero
rows (with a warning), matching the reference's semantics.

A "table" here is any dataset found within ``maxdepth`` of the root (the
reference uses pytables).
"""

from __future__ import annotations

from glob import glob

import numpy as np

from pisa_tpu_torch.utils.hdf5_reader import H5File
from pisa_tpu_torch.utils.log import logging

__all__ = ["HDFTableProxy", "TableAccessor", "HDFChain"]


def _get(f, path):
    """The dataset at `path` of the open file `f`, or None where there is
    none."""
    try:
        if f.is_group(path):
            return None
        return np.asarray(f.read(path))
    except KeyError:
        return None


class HDFTableProxy:
    """Proxy for one dataset path across all files of a chain."""

    def __init__(self, path, dtype, files):
        self.path = path
        self._v_dtype = dtype
        self.files = files

    def _lengths(self):
        out = np.zeros(len(self.files), dtype=int)
        for i, f in enumerate(self.files):
            node = _get(f, self.path)
            if node is None:
                logging.warning(
                    "node %s does not exist in file %s", self.path, f.path
                )
            else:
                out[i] = node.shape[0]
        return out

    def read(self):
        """Concatenated rows of this dataset over every file."""
        parts = []
        for f in self.files:
            node = _get(f, self.path)
            if node is None:
                logging.warning(
                    "node %s does not exist in file %s", self.path, f.path
                )
                continue
            parts.append(node)
        if not parts:
            return np.zeros(0, dtype=self._v_dtype)
        return np.concatenate(parts, axis=0)

    def read_iter(self):
        for f in self.files:
            node = _get(f, self.path)
            if node is not None:
                yield node

    def col(self, colname):
        """One column (structured dtype field) concatenated over the chain."""
        return self.read()[colname]

    def col_iter(self, colname):
        for part in self.read_iter():
            yield part[colname]

    def __len__(self):
        return int(self._lengths().sum())

    def __repr__(self):
        return (
            f"chained table {self.path!r} with {len(self.files)} files,"
            f" {len(self)} rows, dtype={self._v_dtype}"
        )


class TableAccessor:
    """Attribute-style access to the chain's tables by basename
    (reference ``hdfchain.py:86``)."""

    def __init__(self, tabledict):
        self.__dict__.update(tabledict)

    def __repr__(self):
        return ", ".join(
            k for k, v in self.__dict__.items()
            if isinstance(v, HDFTableProxy)
        )


class HDFChain:
    """A chain over multiple HDF5 files (reference ``hdfchain.py:93``).

    Parameters
    ----------
    files : list of paths or glob string
    maxdepth : int
        only datasets at most this deep below the root are chained
    """

    def __init__(self, files, maxdepth=1, verbose=False, **kwargs):
        del kwargs  # h5py.File options of the JAX package's signature
        if isinstance(files, (list, tuple)):
            if len(files) == 0:
                raise ValueError("provided file list is empty!")
            names = list(files)
        elif isinstance(files, str):
            names = sorted(glob(files))
            if not names:
                raise ValueError("glob string matches no file!")
        else:
            raise ValueError(
                "parameter files must be either a list of filenames or a"
                " globstring"
            )
        if verbose:
            logging.info("opening %d files in chain...", len(names))
        self.files = [H5File(n) for n in names]

        self._tables = {}
        self.pathes = {}
        first = self.files[0]

        def visit(group, depth):
            # h5py's visititems order: each member, then its subtree
            for key in first.keys(group):
                name = f"{group.rstrip('/')}/{key}"
                if first.is_group(name):
                    visit(name, depth + 1)
                    continue
                if depth + 1 > maxdepth:
                    continue
                if key in self._tables:
                    logging.warning(
                        "skipping additional occurrence of table %s at %s"
                        " (using %s)!", key, name, self._tables[key].path,
                    )
                    continue
                proxy = HDFTableProxy(name, np.asarray(first.read(name)).dtype,
                                      self.files)
                self._tables[key] = proxy
                self.pathes[name] = proxy

        visit("/", 0)
        self.root = TableAccessor(self._tables)

    def getNode(self, path):
        return self.pathes[path]

    def close(self):
        # guard: __init__ may have raised before self.files existed
        for f in getattr(self, "files", ()):
            f.close()

    def __del__(self):
        self.close()
