"""
Host copy of ``pisa_tpu/utils/spline.py`` with its imports rewritten to
``pisa_tpu_torch``: the maps are the port's ``core/map.py`` ``Map`` and
``MapSet``.

Spline containers (cf. reference ``pisa/utils/spline.py``: ``Spline``,
``CombinedSpline``; ``spline_smooth.py``): encapsulate spline objects with a
prescription for evaluating them over a binning, grouped per flavor, plus a
smoothing helper for 2-D histograms.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate

from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.utils.flavint import NuFlavIntGroup

__all__ = ["Spline", "CombinedSpline", "spline_smooth"]


class Spline:
    """A named spline plus the function evaluating it over a binning.

    Parameters
    ----------
    name : str
    spline : object — underlying spline (any object `eval_spl` understands)
    eval_spl : callable(spline, binning, **kwargs) -> Map
    tex : str, optional
    validate_spl : callable(binning), optional
    hash : optional
    """

    def __init__(
        self, name, spline, eval_spl, tex=None, validate_spl=None, hash=None,
    ):
        self.name = name
        self.spline = spline
        self.hash = hash
        if tex is None:
            try:
                tex = "+".join(
                    fi.tex for fi in NuFlavIntGroup(name)
                )
            except ValueError:
                tex = name
        self.tex = tex
        self._eval_spl = eval_spl
        self._validate_spl = validate_spl

    def get_map(self, binning, **kwargs) -> Map:
        """Evaluate the spline over `binning`, returning a Map."""
        if self._validate_spl is not None:
            self._validate_spl(binning)
        return self._eval_spl(self.spline, binning, name=self.name, **kwargs)

    def get_integrated_map(self, binning, bw_units=None, **kwargs) -> Map:
        """Evaluate then multiply by bin volumes (rate -> counts)."""
        m = self.get_map(binning, **kwargs)
        volumes = binning.bin_volumes(attach_units=False)
        return Map(
            name=m.name, hist=np.asarray(m.hist) * volumes, binning=binning
        )


class CombinedSpline:
    """A collection of :class:`Spline` objects keyed by name, with MapSet
    evaluation (cf. reference ``spline.py:CombinedSpline``)."""

    def __init__(self, splines, interactions=False):
        if isinstance(splines, Spline):
            splines = [splines]
        self._splines = {s.name: s for s in splines}
        self.interactions = interactions

    @property
    def names(self):
        return list(self._splines.keys())

    def __getitem__(self, name):
        return self._splines[name]

    def __iter__(self):
        return iter(self._splines.values())

    def get_spline(self, name):
        return self._splines[name]

    def get_map(self, name, binning, **kwargs):
        return self._splines[name].get_map(binning, **kwargs)

    def get_mapset(self, binning, **kwargs) -> MapSet:
        return MapSet(
            [s.get_map(binning, **kwargs) for s in self],
            name="combined_splines",
        )


def spline_smooth(
    array, spline_binning, eval_binning, axis=0, smooth_factor=5, k=3,
    errors=None,
):
    """Smooth a 2-D array along `axis` with weighted smoothing splines and
    evaluate on a new binning (cf. reference ``spline_smooth.py``).

    Parameters
    ----------
    array : 2-D array of values at `spline_binning` centers along `axis`
    spline_binning : OneDimBinning — binning of the smoothed axis
    eval_binning : OneDimBinning — binning at which to evaluate
    axis : 0 or 1
    smooth_factor : float — UnivariateSpline s parameter scale
    k : int — spline order
    errors : optional array like `array` — per-point uncertainties (weights)

    Returns
    -------
    smoothed : 2-D array with `axis` re-sampled onto `eval_binning`
    """
    array = np.asarray(array, dtype=np.float64)
    if array.ndim != 2:
        raise ValueError("spline_smooth expects a 2-D array")
    if axis == 1:
        array = array.T
        errors = None if errors is None else np.asarray(errors).T

    x = np.asarray(spline_binning.weighted_centers.magnitude)
    x_eval = np.asarray(eval_binning.weighted_centers.magnitude)

    out = np.empty((len(x_eval), array.shape[1]))
    for j in range(array.shape[1]):
        y = array[:, j]
        if errors is not None:
            err = np.asarray(errors[:, j], dtype=np.float64)
            w = np.where(err > 0, 1.0 / np.clip(err, 1e-300, None), 0.0)
        else:
            w = None
        spl = interpolate.UnivariateSpline(
            x, y, w=w, k=k, s=smooth_factor
        )
        out[:, j] = spl(x_eval)

    if axis == 1:
        out = out.T
    return out
