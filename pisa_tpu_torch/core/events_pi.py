"""
Host copy of ``pisa_tpu/core/events_pi.py`` with its imports rewritten to
``pisa_tpu_torch``; HDF5 files are read by the port's own reader
(``utils/hdf.py``), so no ``h5py`` is needed.

EventsPi: container of per-category structured event arrays loaded from
PISA-format HDF5 files (cf. reference ``pisa/core/events_pi.py:105``).

Supports the legacy nested ``{flavor: {cc/nc: {var: array}}}`` layout, the
flat ``{flavint: {var: array}}`` layout (the ``metadata`` group that
``core/events.py:Events.save`` writes beside it is skipped),
pdg_code/interaction splitting, variable mapping (with column stacking),
the legacy "oppo" flux fix, deterministic down-sampling into statistically
independent sub-samples, and string cuts.
"""

from __future__ import annotations

import copy
import re
from collections import OrderedDict
from collections.abc import Mapping, Sequence

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.utils.hdf import from_hdf
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = [
    "NU_FLAVORS",
    "NU_INTERACTIONS",
    "OUTPUT_NUFLAVINT_KEYS",
    "LEGACY_FLAVKEY_XLATION",
    "EventsPi",
    "split_nu_events_by_flavor_and_interaction",
    "fix_oppo_flux",
]

NU_FLAVORS = OrderedDict(
    nue=12, nuebar=-12, numu=14, numubar=-14, nutau=16, nutaubar=-16
)
NU_INTERACTIONS = OrderedDict(cc=1, nc=2)
OUTPUT_NUFLAVINT_KEYS = tuple(
    f"{fk}_{ik}" for fk in NU_FLAVORS for ik in NU_INTERACTIONS
)
LEGACY_FLAVKEY_XLATION = dict(
    nue="nue", nuebar="nuebar", nue_bar="nuebar",
    numu="numu", numubar="numubar", numu_bar="numubar",
    nutau="nutau", nutaubar="nutaubar", nutau_bar="nutaubar",
)

OPPO_FLUX_LEGACY_FIX_MAPPING_NU = {
    "nominal_nue_flux": "neutrino_nue_flux",
    "nominal_numu_flux": "neutrino_numu_flux",
    "nominal_nuebar_flux": "neutrino_oppo_nue_flux",
    "nominal_numubar_flux": "neutrino_oppo_numu_flux",
}
OPPO_FLUX_LEGACY_FIX_MAPPING_NUBAR = {
    "nominal_nue_flux": "neutrino_oppo_nue_flux",
    "nominal_numu_flux": "neutrino_oppo_numu_flux",
    "nominal_nuebar_flux": "neutrino_nue_flux",
    "nominal_numubar_flux": "neutrino_numu_flux",
}


def _append_arrays_dict(key, val, sdict):
    if isinstance(val, Mapping):
        sub = sdict.setdefault(key, OrderedDict())
        for k2, v2 in val.items():
            _append_arrays_dict(k2, v2, sub)
    else:
        arr = np.asarray(val)
        if key in sdict:
            sdict[key] = np.append(sdict[key], arr)
        else:
            sdict[key] = arr


class EventsPi(OrderedDict):
    """Per-category event store (cf. reference ``events_pi.py:105``)."""

    def __init__(
        self,
        *args,
        name=None,
        neutrinos=True,
        fraction_events_to_keep=None,
        events_subsample_index=0,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.name = name
        self.neutrinos = neutrinos
        self.fraction_events_to_keep = fraction_events_to_keep
        self.events_subsample_index = int(events_subsample_index)
        if self.fraction_events_to_keep is not None:
            f = float(self.fraction_events_to_keep)
            if not 0.0 <= f <= 1.0:
                raise ValueError("fraction_events_to_keep must be in [0,1]")
            n_sub = int(1.0 / f)
            if self.events_subsample_index >= n_sub:
                raise ValueError(
                    f"subsample index {self.events_subsample_index} out of"
                    f" range for fraction {f} (max {n_sub - 1})"
                )
        self.metadata = OrderedDict(
            [
                ("detector", ""), ("geom", ""), ("runs", []),
                ("proc_ver", ""), ("cuts", []),
            ]
        )

    # -- loading -----------------------------------------------------------------
    def load_events_file(
        self, events_file, variable_mapping=None, required_metadata=None,
        seed=123456,
    ):
        """Fill from HDF5 file(s) or already-loaded mapping(s)
        (cf. reference ``events_pi.py:175``)."""
        if isinstance(events_file, (str, Mapping)):
            events_files_list = [events_file]
        elif isinstance(events_file, Sequence):
            events_files_list = list(events_file)
        else:
            raise TypeError(f"bad events_file type {type(events_file)}")

        if variable_mapping is not None and not isinstance(
            variable_mapping, Mapping
        ):
            raise TypeError("variable_mapping must be a mapping")

        input_data = OrderedDict()
        for infile in events_files_list:
            if isinstance(infile, str):
                file_data = from_hdf(find_resource(infile))
            else:
                file_data = infile
            if not isinstance(file_data, Mapping) or not file_data:
                raise TypeError(f"no event data loaded from {infile}")
            for k, v in file_data.items():
                if k == "metadata":
                    # the bookkeeping that Events.save writes beside the
                    # categories (make_events_file's output); the JAX
                    # package's loader raises on it
                    continue
                _append_arrays_dict(k, v, input_data)

            if required_metadata is not None:
                file_meta = getattr(file_data, "attrs", None) or {}
                for k in required_metadata:
                    if k not in file_meta:
                        raise KeyError(f"expected metadata {k!r} not found")
                    if k in self.metadata and k == "livetime":
                        self.metadata[k] += file_meta[k]
                    else:
                        self.metadata[k] = file_meta[k]

        if self.neutrinos:
            input_data = split_nu_events_by_flavor_and_interaction(
                input_data
            )
            fix_oppo_flux(input_data)

        rand = np.random.RandomState(seed)
        for data_key, cat in input_data.items():
            if data_key in self:
                raise ValueError(f"key {data_key!r} already present")
            self[data_key] = OrderedDict()

            if variable_mapping is None:
                mapping_items = [(k, k) for k in cat.keys()]
            else:
                mapping_items = list(variable_mapping.items())

            chosen = None
            for var_dst, var_src in mapping_items:
                if isinstance(var_src, str):
                    var_src = [var_src]
                cols = []
                for var in var_src:
                    if var not in cat:
                        raise KeyError(
                            f"variable {var!r} not found for {data_key!r}"
                        )
                    cols.append(np.asarray(cat[var]).astype(FTYPE))
                arr = np.squeeze(np.stack(cols, axis=1))

                if self.fraction_events_to_keep is not None:
                    if chosen is None:
                        chosen = self._choose_subsample(arr.shape[0], rand)
                    arr = arr[chosen]
                self[data_key][var_dst] = arr

    def _choose_subsample(self, n_events, rand):
        """Deterministic, statistically-independent sub-samples
        (cf. reference ``events_pi.py:118-160,460-500``)."""
        desired = int(float(self.fraction_events_to_keep) * n_events)
        current = np.arange(n_events)
        i = 0
        while True:
            if current.size < desired:
                raise ValueError("not enough events for requested subsample")
            chosen = np.sort(rand.choice(current, replace=False, size=desired))
            if i == self.events_subsample_index:
                return chosen
            current = np.sort(np.setxor1d(current, chosen))
            i += 1

    # -- cuts --------------------------------------------------------------------
    def apply_cut(self, keep_criteria):
        """Keep events satisfying a numpy boolean expression over the event
        variables (cf. reference ``events_pi.py:510``)."""
        if not isinstance(keep_criteria, str):
            raise TypeError("keep_criteria must be a string")
        if keep_criteria in self.metadata["cuts"]:
            logging.debug("cut %r already applied", keep_criteria)
            return self

        cut_data = EventsPi(name=self.name, neutrinos=self.neutrinos)
        cut_data.metadata = copy.deepcopy(self.metadata)
        for key in self.keys():
            namespace = {"np": np}
            namespace.update(
                {var: np.asarray(v) for var, v in self[key].items()}
            )
            mask = np.asarray(
                eval(  # noqa: S307 - restricted to event arrays + np
                    keep_criteria, {"__builtins__": {}}, namespace
                ),
                dtype=bool,
            )
            cut_data[key] = OrderedDict(
                (var, np.asarray(v)[mask]) for var, v in self[key].items()
            )
        cut_data.metadata["cuts"].append(keep_criteria)
        return cut_data

    def keep_inbounds(self, binning):
        """Cut events outside `binning` (cf. reference
        ``events_pi.py:586``)."""
        from pisa_tpu_torch.core.binning import MultiDimBinning, OneDimBinning

        if isinstance(binning, OneDimBinning):
            binning = MultiDimBinning([binning])
        crits = []
        for dim in binning:
            lo = dim.bin_edges[0].magnitude
            hi = dim.bin_edges[-1].magnitude
            crits.append(
                f"({dim.name} >= {lo!r}) & ({dim.name} <= {hi!r})"
            )
        return self.apply_cut(" & ".join(crits))

    def __str__(self):
        lines = [f"EventsPi({self.name!r}):"]
        for key, cat in self.items():
            lines.append(
                f"  {key}: {len(next(iter(cat.values()), []))} events,"
                f" vars {list(cat.keys())}"
            )
        return "\n".join(lines)


def split_nu_events_by_flavor_and_interaction(input_data):
    """{category: vars} -> {flavint: vars} (cf. reference
    ``events_pi.py:640``)."""
    if not isinstance(input_data, Mapping) or not input_data:
        raise ValueError("input_data must be a non-empty mapping")

    output = OrderedDict()
    for key, data in input_data.items():
        if key in OUTPUT_NUFLAVINT_KEYS:
            if key in output:
                for var in output[key]:
                    output[key][var] = np.concatenate(
                        [output[key][var], data[var]]
                    )
            else:
                output[key] = data
            continue

        if key in LEGACY_FLAVKEY_XLATION:
            flav = LEGACY_FLAVKEY_XLATION[key]
            for sub_key, sub_data in data.items():
                if sub_key not in ("cc", "nc"):
                    raise ValueError(f"unexpected interaction key {sub_key!r}")
                output[f"{flav}_{sub_key}"] = sub_data
            continue

        if "pdg_code" not in data or "interaction" not in data:
            raise ValueError(
                f"cannot split {key!r}: needs pdg_code and interaction"
            )
        for fk, fc in NU_FLAVORS.items():
            for ik, ic in NU_INTERACTIONS.items():
                mask = (data["pdg_code"] == fc) & (data["interaction"] == ic)
                if np.any(mask):
                    output[f"{fk}_{ik}"] = OrderedDict(
                        (var, np.asarray(v)[mask])
                        for var, v in data.items()
                    )

    if not output:
        raise ValueError("failed splitting events by flavor/interaction")
    return output


def fix_oppo_flux(input_data):
    """Rename legacy 'oppo' flux variables (cf. reference
    ``events_pi.py:725``)."""
    for key, val in input_data.items():
        if "neutrino_oppo_nue_flux" not in val:
            continue
        logging.warning(
            "renaming outdated 'oppo' flux keys in %r", key
        )
        mapping = (
            OPPO_FLUX_LEGACY_FIX_MAPPING_NUBAR
            if "bar" in key
            else OPPO_FLUX_LEGACY_FIX_MAPPING_NU
        )
        for new, old in mapping.items():
            val[new] = val.pop(old)
