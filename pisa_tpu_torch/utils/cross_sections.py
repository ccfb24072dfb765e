"""
Host copy of ``pisa_tpu/utils/cross_sections.py`` with its imports
rewritten to ``pisa_tpu_torch``; the tables are read in place from
``pisa_tpu/resources/cross_sections/`` (``utils/resources.py``).

Neutrino cross-sections store (cf. reference
``pisa/utils/cross_sections.py:48``): per-flavint total CC/NC cross-sections
vs energy from the GENIE tables (``cross_sections/cross_sections.json``;
per-H2O-molecule, m^2), with interpolated lookup.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch.utils.fileio import from_file
from pisa_tpu_torch.utils.flavint import ALL_NUFLAVINTS_LIST, NuFlavInt
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["CrossSections"]


class CrossSections:
    """Parameters
    ----------
    ver : str — table version, e.g. 'genie_2.8.6'
    xsec : str — resource path of the cross-sections JSON
    """

    def __init__(
        self, ver="genie_2.8.6", xsec="cross_sections/cross_sections.json"
    ):
        data = from_file(find_resource(xsec))
        if ver not in data:
            raise ValueError(
                f"version {ver!r} not in file (have {list(data)})"
            )
        self.ver = ver
        table = data[ver]
        self.energy = np.asarray(table["energy"], dtype=np.float64)
        self._xsec = {}
        for flav_key, channels in table["xsec"].items():
            flav = flav_key.replace("_bar", "bar")
            for int_type, values in channels.items():
                fi = NuFlavInt(flav, int_type)
                self._xsec[fi] = np.asarray(values, dtype=np.float64)

    @property
    def flavints(self):
        return tuple(self._xsec.keys())

    def __getitem__(self, key):
        return self._xsec[NuFlavInt(key)]

    def get_xs_value(self, flavint, energy):
        """Interpolated cross-section [m^2 / H2O molecule] at `energy` [GeV]."""
        return np.interp(
            np.asarray(energy), self.energy, self._xsec[NuFlavInt(flavint)]
        )

    def get_xs_ratio_value(self, flavint0, flavint1, energy):
        """Ratio of two flavints' cross-sections at `energy`."""
        a = self.get_xs_value(flavint0, energy)
        b = self.get_xs_value(flavint1, energy)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(b != 0, a / b, np.nan)

    def total(self, flav, energy):
        """CC + NC total for a flavor at `energy`."""
        return self.get_xs_value((flav, "cc"), energy) + self.get_xs_value(
            (flav, "nc"), energy
        )


def test_CrossSections():  # noqa: N802 - reference-style embedded test name
    xs = CrossSections()
    assert len(xs.flavints) == 12
    v = xs.get_xs_value("numu_cc", 10.0)
    assert np.isfinite(v) and v > 0
    # CC > NC for numu at 10 GeV
    assert v > xs.get_xs_value("numu_nc", 10.0)
    # nu vs nubar ratio > 1 at these energies
    assert xs.get_xs_ratio_value("numu_cc", "numubar_cc", 20.0) > 1.0
