"""
Host copy of ``pisa_tpu/utils/data_proc_params.py`` with its imports
rewritten to ``pisa_tpu_torch``; a source file path is read by the port's
own HDF5 reader (``utils/hdf5_reader.py``) instead of ``h5py``.

Data-processing parameters for event extraction (cf. reference
``pisa/utils/data_proc_params.py:57``): per-detector / per-processing-
version specs of where fields live in the source HDF5 files
(``field_map``), named cuts (``cuts``: fields + a ``pass_if`` expression),
and PID specs — driving the ``make_events_file`` workflow.

Differences from the reference: cut expressions are evaluated in a
restricted namespace (the cut's fields + numpy + pi) rather than via
module-globals injection, and sources may be HDF5 file paths or plain
dicts of arrays.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np

from pisa_tpu_torch.utils.flavint import FlavIntData, IntType, NuFlav
from pisa_tpu_torch.utils.hdf5_reader import read_hdf5
from pisa_tpu_torch.utils.log import logging

__all__ = ["DataProcParams"]

NU_PDG_CODES = (12, -12, 14, -14, 16, -16)


def _node(source, path):
    """Fetch `path` ('a/b/c') from a nested dict."""
    node = source
    for part in str(path).split("/"):
        if not part:
            continue
        node = node[part]
    return np.asarray(node)


class DataProcParams(dict):
    """Parameters for one detector + processing version
    (cf. reference ``data_proc_params.py:235``).

    Parameters
    ----------
    detector : string (case-insensitive key into the spec)
    proc_ver : string; matched against spec keys allowing a 'v' prefix
    data_proc_params : dict or path to JSON spec
        {detector: {proc_ver: {'field_map': ..., 'cuts': ..., 'pid': ...}}}
    """

    def __init__(self, detector, proc_ver, data_proc_params=None):
        super().__init__()
        if data_proc_params is None:
            data_proc_params = "events/data_proc_params.json"
        if isinstance(data_proc_params, str):
            from pisa_tpu_torch.utils.fileio import from_file
            from pisa_tpu_torch.utils.resources import find_resource

            ps = from_file(find_resource(data_proc_params))
        elif isinstance(data_proc_params, dict):
            ps = data_proc_params
        else:
            raise TypeError(
                f"Unhandled data_proc_params type: {type(data_proc_params)}"
            )
        self.detector = detector
        self.proc_ver = str(proc_ver)
        det_matches = [
            k for k in ps if str(k).lower() == detector.lower()
        ]
        if not det_matches:
            raise KeyError(f"detector {detector!r} not in spec ({list(ps)})")
        self.det_key = det_matches[0]

        self.procver_key = None
        lpv = self.proc_ver.lower()
        for key in ps[self.det_key]:
            lk = str(key).lower()
            if lk == lpv or "v" + lk == lpv or lk == "v" + lpv:
                self.procver_key = key
        if self.procver_key is None:
            raise KeyError(
                f"processing version {proc_ver!r} not found for detector"
                f" {detector!r} (have {list(ps[self.det_key])})"
            )
        self.update(ps[self.det_key][self.procver_key])

        # optional non-PDG -> PDG flavor-code translation
        self.trans_nu_code = "nu_code_to_pdg_map" in self
        if self.trans_nu_code:
            self.nu_code_to_pdg_map = {
                int(code): pdg
                for code, pdg in self["nu_code_to_pdg_map"].items()
            }

        # generic cuts available everywhere (reference :278-301)
        self.setdefault("cuts", {})
        self["cuts"].update(
            {
                str(NuFlav(12).bar_code).lower(): {
                    "fields": ["nu_code"], "pass_if": "nu_code > 0",
                },
                str(NuFlav(-12).bar_code).lower(): {
                    "fields": ["nu_code"], "pass_if": "nu_code < 0",
                },
                str(IntType("cc")).lower(): {
                    "fields": ["interaction_type"],
                    "pass_if": "interaction_type == 1",
                },
                str(IntType("nc")).lower(): {
                    "fields": ["interaction_type"],
                    "pass_if": "interaction_type == 2",
                },
                "true_upgoing_zen": {
                    "fields": ["true_zenith"], "pass_if": "true_zenith > pi/2",
                },
                "true_upgoing_coszen": {
                    "fields": ["true_coszen"], "pass_if": "true_coszen < 0",
                },
            }
        )
        self.validate_cut_spec(self["cuts"])
        if "pid" in self:
            self.validate_pid_spec(self["pid"])

    # -- validation (reference :306-348) ---------------------------------------
    @staticmethod
    def validate_cut_spec(cuts):
        for cutname, cutspec in cuts.items():
            assert isinstance(cutname, str)
            assert cutname == cutname.lower() == cutname.strip()
            assert set(cutspec) == {"fields", "pass_if"}
            assert hasattr(cutspec["fields"], "__iter__")
            assert not isinstance(cutspec["fields"], str)
            assert isinstance(cutspec["pass_if"], str)

    @staticmethod
    def validate_pid_spec(pids):
        for name, pidspec in pids.items():
            assert isinstance(name, str)
            assert name == name.lower() == name.strip()
            assert set(pidspec) == {"fields", "criteria"}
            assert hasattr(pidspec["fields"], "__iter__")
            assert not isinstance(pidspec["fields"], str)
            assert isinstance(pidspec["criteria"], str)

    # -- extraction --------------------------------------------------------------
    @staticmethod
    def retrieve_node_data(source, address, allow_missing=False):
        """Array at `address` in a nested dict
        (cf. reference :420)."""
        try:
            return _node(source, address)
        except KeyError:
            if allow_missing:
                return None
            raise

    @staticmethod
    def retrieve_expression(source, expression):
        """Evaluate an expression whose identifiers are node paths —
        '/'-separated or root-level dataset names (cf. reference :348);
        plain paths are returned directly."""
        import re

        tokens = re.findall(r"[A-Za-z_][\w/]*", str(expression))
        if tokens == [str(expression)]:
            return _node(source, expression)
        ns = {"np": np, "numpy": np, "pi": np.pi}
        expr = str(expression)
        for i, tok in enumerate(sorted(set(tokens), key=len, reverse=True)):
            if tok in ns:
                continue
            try:
                value = _node(source, tok)
            except (KeyError, TypeError):
                # not a node (e.g. an attribute name like 'cos' in
                # 'np.cos(...)'); leave it for eval to resolve or reject
                continue
            name = f"_f{i}"
            ns[name] = value
            # substitute whole identifiers only (no partial-token or
            # attribute-access matches)
            expr = re.sub(
                rf"(?<![\w.]){re.escape(tok)}(?![\w])", name, expr
            )
        return np.asarray(
            eval(expr, {"__builtins__": {}}, ns)  # noqa: S307 - restricted
        )

    def get_data(self, source, run_settings=None, flav=None):  # noqa: ARG002
        """Extract every field of ``field_map`` from `source` (an HDF5 file
        path, read whole by the port's reader, or a nested dict) and
        interpret (cf. reference :477)."""
        if isinstance(source, str):
            source = read_hdf5(os.path.expandvars(os.path.expanduser(source)))
        data = {}
        for name, path in self["field_map"].items():
            data[name] = np.asarray(self.retrieve_expression(source, path))
        return self.interpret_data(data)

    def interpret_data(self, data):
        """Translate flavor codes to PDG and derive coszen fields
        (cf. reference :557)."""
        if self.trans_nu_code and "nu_code" in data:
            data["nu_code"] = np.asarray(
                [self.nu_code_to_pdg_map[int(c)] for c in data["nu_code"]]
            )
        if "true_zenith" in data:
            data["true_coszen"] = np.cos(np.asarray(data["true_zenith"]))
        if "reco_zenith" in data:
            data["reco_coszen"] = np.cos(np.asarray(data["reco_zenith"]))
        return data

    # -- cutting -------------------------------------------------------------------
    @staticmethod
    def subselect(data, fields, indices=None):
        """Restrict to `fields` (optionally row-indexed) (reference :581)."""
        if isinstance(data, FlavIntData):
            out = FlavIntData()
            for flavint in data.flavints:
                out[flavint] = DataProcParams.subselect(
                    data[flavint], fields=fields, indices=indices
                )
            return out
        if isinstance(data, Mapping):
            if indices is None:
                return {k: v for k, v in data.items() if k in fields}
            return {
                k: np.asarray(v)[indices]
                for k, v in data.items()
                if k in fields
            }
        raise TypeError(f"Unhandled data type {type(data)}")

    def cut_bool_idx(self, data, cuts, boolean_op="&"):
        """Boolean keep-mask for `cuts` over `data`'s fields."""
        if isinstance(cuts, (str, dict)):
            cuts = [cuts]
        cut_strings, cut_fields = [], set()
        for cut in cuts:
            if isinstance(cut, dict):
                self.validate_cut_spec({"inline": cut} if "pass_if" in cut else cut)
                spec = cut if "pass_if" in cut else next(iter(cut.values()))
            elif str(cut).lower() in self["cuts"]:
                spec = self["cuts"][str(cut).lower()]
            else:
                raise ValueError(f"Unrecognized or invalid cut: {cut!r}")
            if spec["pass_if"] not in cut_strings:
                cut_strings.append(spec["pass_if"])
            cut_fields.update(spec["fields"])
        cut_string = boolean_op.join(f"({cs})" for cs in cut_strings)
        ns = {f: np.asarray(data[f]) for f in cut_fields}
        ns.update({"np": np, "pi": np.pi})
        try:
            return np.asarray(
                eval(cut_string, {"__builtins__": {}}, ns),  # noqa: S307
                dtype=bool,
            )
        except Exception:
            logging.error("Failed to evaluate cut_string %r", cut_string)
            raise

    def apply_cuts(self, data, cuts, boolean_op="&", return_fields=None):
        """Apply `cuts`; return `return_fields` (default all) of passing
        rows (cf. reference :593). Accepts a flat dict or FlavIntData."""
        if isinstance(data, FlavIntData):
            out = FlavIntData()
            for flavint in data.flavints:
                out[flavint] = self.apply_cuts(
                    data[flavint], cuts=cuts, boolean_op=boolean_op,
                    return_fields=return_fields,
                )
            return out
        if isinstance(cuts, (str, dict)):
            cuts = [cuts]
        if return_fields is None:
            return_fields = list(data.keys())
        if len(cuts) == 0:
            return self.subselect(data, return_fields)
        mask = self.cut_bool_idx(data, cuts, boolean_op=boolean_op)
        return {f: np.asarray(data[f])[mask] for f in return_fields}
