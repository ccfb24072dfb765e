"""
Host copy of ``pisa_tpu/core/events.py`` with its imports rewritten to
``pisa_tpu_torch``.

Legacy events containers (cf. reference ``pisa/core/events.py:54,421``):

- :class:`Events` — per-flavint dict of column arrays (``FlavIntData``)
  with metadata, cut bookkeeping, and direct histogramming into
  :class:`~pisa_tpu_torch.core.map.Map` objects. Used by the legacy event-file
  production workflow (``make_events_file``-style scripts).
- :class:`Data` — per-flavint-*group* dict (``FlavIntDataGroup``), with
  'muons' and 'noise' side-bands, group transformations, and
  ``histogram_set`` producing a full MapSet.

The modern pipeline path uses :class:`~pisa_tpu_torch.core.events_pi.EventsPi` +
Containers; these classes exist for parity with reference tools and for
users migrating legacy analyses. Cut expressions are evaluated in a
restricted namespace (field arrays + ``np``), like
``Container.get_keep_mask``.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.utils.flavint import (
    FlavIntData,
    FlavIntDataGroup,
    NuFlavInt,
    NuFlavIntGroup,
    flavint_groups_from_string,
)
from pisa_tpu_torch.utils.hash import hash_obj
from pisa_tpu_torch.utils.log import logging

__all__ = ["Events", "Data"]


def _as_multidim(binning):
    if isinstance(binning, OneDimBinning):
        return MultiDimBinning([binning])
    if isinstance(binning, MultiDimBinning):
        return binning
    raise TypeError(f"Unhandled binning type {type(binning)}")


def _eval_cut(keep_criteria, fields):
    """Evaluate a cut string against a dict of field arrays in a restricted
    namespace (cf. reference ``events.py:277``; numpy available as ``np``)."""
    names = {k: np.asarray(v) for k, v in fields.items()}
    names["np"] = np
    mask = eval(  # noqa: S307 - namespace restricted to event arrays
        keep_criteria, {"__builtins__": {}}, names
    )
    return np.asarray(mask, dtype=bool)


def _histogram_fields(fields, binning, binning_cols, weights_col, errors,
                      name, tex):
    binning = _as_multidim(binning)
    if isinstance(binning_cols, str):
        binning_cols = [binning_cols]
    if binning_cols is None:
        binning_cols = binning.names
    else:
        assert set(binning_cols).issubset(set(binning.names))
    bin_edges = [
        np.asarray(d.edge_magnitudes) for d in binning.dims
        if d.name in binning_cols
    ]
    sample = [np.asarray(fields[col]) for col in binning_cols]
    weights = (
        np.asarray(fields[weights_col]) if weights_col is not None else None
    )
    hist, _ = np.histogramdd(sample=sample, weights=weights, bins=bin_edges)
    err = None
    if errors:
        w2 = (
            np.square(weights) if weights is not None
            else np.ones_like(sample[0])
        )
        sumw2, _ = np.histogramdd(sample=sample, weights=w2, bins=bin_edges)
        err = np.sqrt(sumw2)
    return Map(name=name, hist=hist, binning=binning, error_hist=err, tex=tex)


class Events(FlavIntData):
    """Per-flavint event columns with metadata and cut tracking
    (cf. reference ``events.py:54``).

    Parameters
    ----------
    val : None, dict, or path
        Mapping flavint -> {column: array} (or a JSON/HDF5 file holding
        one, loaded via :func:`pisa_tpu_torch.utils.fileio.from_file`).
    """

    def __init__(self, val=None):
        self.metadata = {
            "detector": "",
            "geom": "",
            "runs": [],
            "proc_ver": "",
            "cuts": [],
            "flavints_joined": [],
        }
        meta = {}
        if isinstance(val, str):
            from pisa_tpu_torch.utils.fileio import from_file

            loaded = from_file(val)
            meta = dict(loaded.get("metadata", {})) if isinstance(
                loaded, dict
            ) and "metadata" in loaded else {}
            val = {
                k: v for k, v in dict(loaded).items() if k != "metadata"
            }
        super().__init__(val)
        self.metadata.update(meta)
        self._hash = None
        self.update_hash()

    def __str__(self):
        meta = [f"{k} : {v}" for k, v in self.metadata.items()]
        return "\n".join(meta)

    def __repr__(self):
        return f"Events({len(self.flavints_present)} flavints)"

    @property
    def hash(self):
        return self._hash

    def __hash__(self):
        return self._hash if self._hash is not None else 0

    def update_hash(self):
        self._hash = hash_obj(self.metadata)

    @property
    def flavint_groups(self):
        """Joined flavint groups from metadata (singletons otherwise)."""
        return flavint_groups_from_string(self.joined_string)

    @property
    def joined_string(self):
        joined = self.metadata.get("flavints_joined")
        if joined:
            return ";".join(str(j) for j in joined)
        return None if joined is None else ""

    @property
    def flavints_present(self):
        """Flavints that actually hold data."""
        out = []
        for fi in self.flavints:
            v = self[fi]
            if isinstance(v, dict) and v:
                out.append(fi)
        return tuple(out)

    def meta_eq(self, other):
        from pisa_tpu_torch.utils.comparisons import recursiveEquality

        return recursiveEquality(self.metadata, other.metadata)

    def data_eq(self, other):
        from pisa_tpu_torch.utils.comparisons import recursiveEquality

        return recursiveEquality(dict(self), dict(other))

    def __eq__(self, other):
        return self.meta_eq(other) and self.data_eq(other)

    def save(self, fname, **kwargs):
        from pisa_tpu_torch.utils.fileio import to_file

        state = {str(fi): self[fi] for fi in self.flavints_present}
        state["metadata"] = self.metadata
        to_file(state, fname, **kwargs)

    def histogram(self, kinds, binning, binning_cols=None, weights_col=None,
                  errors=False, name=None, tex=None):
        """Histogram one flavint group's events into a Map
        (cf. reference ``events.py:176``)."""
        if not isinstance(kinds, NuFlavIntGroup):
            kinds = NuFlavIntGroup(kinds)
        if name is None:
            name = str(kinds)
            if weights_col is not None:
                name += f", weights={weights_col}"
        # representative flavint holds the (already joined) sample
        fields = self[kinds[0]]
        return _histogram_fields(
            fields, binning, binning_cols, weights_col, errors, name, tex
        )

    def applyCut(self, keep_criteria):  # noqa: N802 - reference API
        """Return a new Events keeping rows satisfying `keep_criteria`
        (a boolean expression over column names; ``np`` available).
        Cuts already recorded in metadata are skipped
        (cf. reference ``events.py:277``)."""
        if keep_criteria is None:
            return self
        if keep_criteria in self.metadata["cuts"]:
            logging.debug(
                "Criteria %r already applied; returning unmodified.",
                keep_criteria,
            )
            return self
        remaining = {}
        for fi in self.flavints_present:
            fields = self[fi]
            mask = _eval_cut(keep_criteria, fields)
            remaining[str(fi)] = {
                k: np.asarray(v)[mask] for k, v in fields.items()
            }
        out = Events(remaining)
        out.metadata.update(deepcopy(self.metadata))
        out.metadata["cuts"] = list(self.metadata["cuts"]) + [keep_criteria]
        out.update_hash()
        return out

    def keepInbounds(self, binning):  # noqa: N802 - reference API
        """Cut events outside `binning` (outer-edge events kept;
        cf. reference ``events.py:352``)."""
        binning = _as_multidim(binning)
        current = self.metadata["cuts"]
        new_cuts = [d.inbounds_criteria for d in binning.dims]
        unapplied = [c for c in new_cuts if c not in current]
        if not unapplied:
            return self
        out = self.applyCut(" & ".join(f"({c})" for c in unapplied))
        out.metadata["cuts"] = deepcopy(current) + unapplied
        out.update_hash()
        return out


class Data(FlavIntDataGroup):
    """Grouped events plus 'muons'/'noise' side-bands
    (cf. reference ``events.py:421``)."""

    def __init__(self, val=None, flavint_groups=None, metadata=None):
        self.metadata = {
            "name": "",
            "detector": "",
            "livetime": "",
            "type": "",
            "cuts": [],
            "flavints_joined": [],
        }
        self.contains_neutrinos = False
        self.contains_muons = False
        self.contains_noise = False

        side_bands = {}
        if isinstance(val, dict):
            val = dict(val)
            for side in ("muons", "noise"):
                if side in val:
                    side_bands[side] = val.pop(side)
            if val:
                self.contains_neutrinos = True
        if self.contains_neutrinos or flavint_groups is not None:
            super(Data, self).__init__(
                val=val if val else None, flavint_groups=flavint_groups
            )
        else:
            dict.__init__(self)
            self._flavint_groups = []
        for side, v in side_bands.items():
            dict.__setitem__(self, side, v)
            setattr(self, f"contains_{side}", True)
        if metadata is not None:
            self.metadata.update(metadata)
        if not self.metadata["flavints_joined"]:
            self.metadata["flavints_joined"] = [
                str(g) for g in self._flavint_groups
            ] + [s for s in ("muons", "noise") if s in side_bands]
        self._hash = None
        self.update_hash()

    # -- side-band accessors (reference events.py:563-601) ---------------------
    @property
    def muons(self):
        return dict.__getitem__(self, "muons")

    @muons.setter
    def muons(self, val):
        dict.__setitem__(self, "muons", val)
        self.contains_muons = True

    @property
    def noise(self):
        return dict.__getitem__(self, "noise")

    @noise.setter
    def noise(self, val):
        dict.__setitem__(self, "noise", val)
        self.contains_noise = True

    @property
    def neutrinos(self):
        return {
            k: v for k, v in self.items() if k not in ("muons", "noise")
        }

    @property
    def names(self):
        return list(self.keys())

    @property
    def hash(self):
        return self._hash

    def __hash__(self):
        return self._hash if self._hash is not None else 0

    def update_hash(self):
        self._hash = hash_obj(self.metadata)

    def __getitem__(self, key):
        if isinstance(key, str) and key.lower() in ("muons", "noise"):
            return dict.__getitem__(self, key.lower())
        return super().__getitem__(key)

    def __setitem__(self, key, val):
        if isinstance(key, str) and key.lower() in ("muons", "noise"):
            dict.__setitem__(self, key.lower(), val)
            setattr(self, f"contains_{key.lower()}", True)
            return
        super().__setitem__(key, val)

    def __contains__(self, key):
        if isinstance(key, str) and key.lower() in ("muons", "noise"):
            return dict.__contains__(self, key.lower())
        return super().__contains__(key)

    def transform_groups(self, flavint_groups):
        """Regroup the neutrino part; side-bands pass through
        (cf. reference ``events.py:716``)."""
        neutrinos = {
            k: v for k, v in self.items() if k not in ("muons", "noise")
        }
        fidg = FlavIntDataGroup(val=neutrinos).transform_groups(
            flavint_groups
        )
        d = dict(fidg)
        metadata = deepcopy(self.metadata)
        metadata["flavints_joined"] = [str(g) for g in fidg.flavint_groups]
        if self.contains_muons:
            metadata["flavints_joined"].append("muons")
            d["muons"] = deepcopy(self.muons)
        if self.contains_noise:
            metadata["flavints_joined"].append("noise")
            d["noise"] = deepcopy(self.noise)
        return Data(d, metadata=metadata)

    def digitize(self, kinds, binning, binning_cols=None):
        """Per-event bin indices (numpy.digitize convention) per binning
        column (cf. reference ``events.py:744``)."""
        binning = _as_multidim(binning)
        if isinstance(binning_cols, str):
            binning_cols = [binning_cols]
        if binning_cols is None:
            binning_cols = binning.names
        key = kinds if isinstance(kinds, str) and kinds.lower() in (
            "muons", "noise"
        ) else str(NuFlavIntGroup(kinds))
        fields = self[key]
        idxs = [
            np.digitize(
                np.asarray(fields[col]),
                np.asarray(binning[col].edge_magnitudes),
            )
            for col in binning_cols
        ]
        return np.vstack(idxs).T

    def histogram(self, kinds, binning, binning_cols=None, weights_col=None,
                  errors=False, name=None, tex=None):
        """Histogram one group (or side-band) into a Map
        (cf. reference ``events.py:793``)."""
        if isinstance(kinds, str) and kinds.lower() in ("muons", "noise"):
            fields = self[kinds.lower()]
            if name is None:
                name = kinds.lower()
        else:
            group = (
                kinds if isinstance(kinds, NuFlavIntGroup)
                else NuFlavIntGroup(kinds)
            )
            fields = self[group]
            if name is None:
                name = str(group)
                if weights_col is not None:
                    name += f", weights={weights_col}"
        return _histogram_fields(
            fields, binning, binning_cols, weights_col, errors, name, tex
        )

    def histogram_set(self, binning, nu_weights_col, mu_weights_col,
                      noise_weights_col, mapset_name, errors=False):
        """Histogram everything in this object into one MapSet
        (cf. reference ``events.py:902``)."""
        maps = []
        if self.contains_neutrinos:
            for key in self.neutrinos:
                maps.append(
                    self.histogram(
                        kinds=key, binning=binning,
                        weights_col=nu_weights_col, errors=errors,
                        name=str(NuFlavIntGroup(key)),
                    )
                )
        if self.contains_muons:
            maps.append(
                self.histogram(
                    kinds="muons", binning=binning,
                    weights_col=mu_weights_col, errors=errors, name="muons",
                )
            )
        if self.contains_noise:
            maps.append(
                self.histogram(
                    kinds="noise", binning=binning,
                    weights_col=noise_weights_col, errors=errors,
                    name="noise",
                )
            )
        return MapSet(maps, name=mapset_name)

    def applyCut(self, keep_criteria):  # noqa: N802 - reference API
        """Cut every group and side-band; returns a new Data
        (cf. reference ``events.py:613``)."""
        if keep_criteria is None or keep_criteria in self.metadata["cuts"]:
            return self
        remaining = {}
        for key in self.names:
            fields = self[key]
            mask = _eval_cut(keep_criteria, fields)
            remaining[key] = {
                k: np.asarray(v)[mask] for k, v in fields.items()
            }
        metadata = deepcopy(self.metadata)
        metadata["cuts"] = list(self.metadata["cuts"]) + [keep_criteria]
        return Data(remaining, metadata=metadata)

    def keepInbounds(self, binning):  # noqa: N802 - reference API
        """Cut out events falling outside `binning`
        (cf. reference ``events.py:697``)."""
        binning = _as_multidim(binning)
        current = self.metadata["cuts"]
        unapplied = [
            d.inbounds_criteria for d in binning.dims
            if d.inbounds_criteria not in current
        ]
        if not unapplied:
            return self
        out = self.applyCut(" & ".join(f"({c})" for c in unapplied))
        out.metadata["cuts"] = deepcopy(current) + unapplied
        out.update_hash()
        return out

    def __add__(self, other):
        """Merge two Data objects (concatenating common groups' fields;
        cf. reference ``events.py:1004``)."""
        d = {}
        keys = set(self.names) | set(other.names)
        for key in keys:
            in_self, in_other = key in self.names, key in other.names
            if in_self and in_other:
                a, b = self[key], other[key]
                fields = set(a.keys()) & set(b.keys())
                d[key] = {
                    f: np.concatenate([np.asarray(a[f]), np.asarray(b[f])])
                    for f in fields
                }
            else:
                src = self if in_self else other
                d[key] = deepcopy(src[key])
        metadata = deepcopy(self.metadata)
        return Data(d, metadata=metadata)

    def __eq__(self, other):
        from pisa_tpu_torch.utils.comparisons import recursiveEquality

        return recursiveEquality(self.metadata, other.metadata) and (
            recursiveEquality(dict(self), dict(other))
        )

    def __str__(self):
        return (
            f"Data(groups={self.names}, "
            f"muons={self.contains_muons}, noise={self.contains_noise})"
        )

    __repr__ = __str__
