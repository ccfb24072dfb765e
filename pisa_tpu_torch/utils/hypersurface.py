"""
Hypersurfaces: per-bin parameterization of discrete detector systematics,
apply side, for the official data-release hyperplanes.

Counterpart of the evaluation half of ``pisa_tpu/utils/hypersurface.py``
(reference ``pisa/utils/hypersurface/hypersurface.py:356`` evaluate,
``:2065`` data-release CSV loading). The data release gives linear
hyperplanes over B bins: an intercept ``(B,)`` and one slope ``(B,)`` per
systematic, evaluated at the raw parameter values (legacy semantics). The
CSV files are read with bz2 and numpy. Fitted hypersurfaces (JSON, with the
other functional forms and nominal shifts), fitting and interpolation are
not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE
from pisa_tpu_torch.core.stage import in_data_type
from pisa_tpu_torch.utils.fileio import read_csv

__all__ = ["Hypersurface", "evaluate_stacked", "load_hypersurfaces"]


class Hypersurface:
    """Linear per-bin hyperplanes: ``scale_b = intercept_b + sum_k
    slope_k[b] * p_k``.

    Parameters
    ----------
    binning : MultiDimBinning
    intercept : (B,) array
    slopes : dict param name -> (B,) array, in evaluation order
    """

    def __init__(self, binning, intercept, slopes):
        self.binning = binning
        self.param_names = list(slopes)
        # rows: intercept, then one slope per param; uploaded per device once
        self._coeffts = np.stack(
            [np.asarray(intercept, dtype=FTYPE)]
            + [np.asarray(slopes[k], dtype=FTYPE) for k in self.param_names]
        )
        self._device_coeffts = {}

    def evaluate(self, param_values, device, lanes=None):
        """Per-bin scale factors, flat ``(binning.size,)`` on `device`
        (reference ``hypersurface.py:356``); `param_values` maps each
        systematic to a float, a 0-d tensor or, with `lanes`, a (lanes, 1)
        one, and the result is then (lanes, binning.size)."""
        if device not in self._device_coeffts:
            self._device_coeffts[device] = torch.as_tensor(
                self._coeffts, dtype=TORCH_FTYPE, device=device
            )
        coeffts = self._device_coeffts[device]
        total = coeffts[0]
        for i, name in enumerate(self.param_names, start=1):
            total = total + coeffts[i] * in_data_type(param_values[name])
        if lanes is not None and total.dim() == 1:
            total = total.expand(lanes, -1)
        return total


def evaluate_stacked(surfaces, param_values, device, cache, lanes=None):
    """The scale factors of several hypersurfaces over the same params and
    bins as one ``(G, B)`` tensor on `device`: ``intercepts + slopes . p``,
    one product for all of them (a category-stacked container's groups,
    ``stages/discr_sys/hypersurfaces.py``). `param_values` maps each
    systematic to a float or a 0-d tensor on `device`, or with `lanes` to a
    (lanes, 1) tensor, and the result is then (lanes, G, B); `cache` (a
    dict the caller keeps) holds the stacked coefficients, uploaded once."""
    names = surfaces[0].param_names
    if any(s.param_names != names for s in surfaces[1:]):
        raise ValueError("hypersurfaces over different params")
    key = (tuple(id(s) for s in surfaces), device)
    if key not in cache:
        coeffts = np.stack([s._coeffts for s in surfaces])  # (G, 1 + P, B)
        cache[key] = torch.as_tensor(coeffts, dtype=TORCH_FTYPE, device=device)
    coeffts = cache[key]
    shape = () if lanes is None else (lanes,)
    p = torch.stack([
        v.to(TORCH_FTYPE).reshape(-1).expand(shape) if lanes is not None
        and isinstance(v, torch.Tensor)
        else v.to(TORCH_FTYPE) if isinstance(v, torch.Tensor)
        else torch.full(shape, float(v), dtype=TORCH_FTYPE, device=device)
        for v in (param_values[name] for name in names)
    ], dim=-1)
    return coeffts[:, 0] + torch.einsum("gpb,...p->...gb", coeffts[:, 1:], p)


_DATA_RELEASE_KEYS = {
    "nue_cc+nuebar_cc": "nue_cc",
    "numu_cc+numubar_cc": "numu_cc",
    "nutau_cc+nutaubar_cc": "nutau_cc",
    "nu_nc+nubar_nc": "all_nc",
}


def load_hypersurfaces(input_file, expected_binning=None):
    """Load the official data-release CSV hyperplanes (reference
    ``hypersurface.py:2065``): one file per merged category (``*`` in
    `input_file` stands for the category tag), with columns for the bin
    centers, ``offset`` and one slope per systematic; rows in the binning's
    flat order.

    Returns OrderedDict map_name -> Hypersurface.
    """
    if not input_file.endswith((".csv", ".csv.bz2")):
        raise NotImplementedError(
            "fitted (JSON) hypersurfaces are not ported yet (ROADMAP queue 1,"
            " item 10)"
        )
    binning = expected_binning
    if binning is None:
        raise ValueError(
            "must provide binning when loading data-release hypersurfaces"
        )
    out = OrderedDict()
    param_names = None
    for map_name, tag in _DATA_RELEASE_KEYS.items():
        table = read_csv(input_file.replace("*", tag))
        for n in binning.names:
            centers_found = np.unique(table.pop(n))
            if centers_found.size != binning[n].num_bins:
                raise ValueError(f"binning mismatch in {tag} for dimension {n}")
        offset = table.pop("offset")
        if param_names is None:
            param_names = list(table)
        elif param_names != list(table):
            raise ValueError("param mismatch between hypersurface files")
        out[map_name] = Hypersurface(binning, offset, table)
    return out
