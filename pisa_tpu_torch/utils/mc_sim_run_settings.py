"""
Host copy of ``pisa_tpu/utils/mc_sim_run_settings.py`` with its imports
rewritten to ``pisa_tpu_torch``.

Monte-Carlo run-settings bookkeeping (cf. reference
``pisa/utils/mcSimRunSettings.py:45,290``): per-run metadata — flavors
simulated, energy/zenith/azimuth ranges, spectral index, total events
generated, GENIE physical fraction — used to derive effective areas from
counted events (``make_events_file`` workflow).

Numeric fields may be simple expressions ('2*pi'); they are evaluated in a
restricted namespace exposing only ``pi`` and ``numpy``.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch.utils.flavint import NuFlavInt, NuFlavIntGroup

__all__ = ["MCSimRunSettings", "DetMCSimRunsSettings"]

_NUMERIC_FIELDS = (
    "azimuth_max",
    "azimuth_min",
    "energy_max",
    "energy_min",
    "physical_events_fract",
    "genie_prescale_factor",
    "nu_to_total_fract",
    "num_events_per_file",
    "num_i3_files",
    "sim_spectral_index",
    "zenith_max",
    "zenith_min",
)


def _eval_numeric(v):
    if isinstance(v, str):
        return eval(  # noqa: S307 - namespace restricted to math constants
            v, {"__builtins__": {}}, {"pi": np.pi, "np": np, "numpy": np}
        )
    return v


class MCSimRunSettings(dict):
    """Settings of one MC production run (cf. reference
    ``mcSimRunSettings.py:45``).

    Parameters
    ----------
    run_settings : dict or path to a JSON file
        Either a single run's settings dict, or the full nested
        {detector: {run: {...}}} structure together with `detector`/`run`.
    run, detector : optional selectors into a nested structure
    """

    def __init__(self, run_settings, run=None, detector=None):
        super().__init__()
        if isinstance(run_settings, str):
            from pisa_tpu_torch.utils.fileio import from_file
            from pisa_tpu_torch.utils.resources import find_resource

            run_settings = from_file(find_resource(run_settings))
        if not isinstance(run_settings, dict):
            raise TypeError(
                f"Unhandled run_settings type: {type(run_settings)}"
            )
        rsd = dict(run_settings)
        if detector is not None and str(detector).lower() in {
            str(k).lower() for k in rsd
        }:
            det_key = [
                k for k in rsd if str(k).lower() == str(detector).lower()
            ][0]
            rsd = rsd[det_key]
        if run is not None and str(run) in {str(k) for k in rsd}:
            run_key = [k for k in rsd if str(k) == str(run)][0]
            rsd = rsd[run_key]
        rsd = self.translate_source_dict(rsd)
        self.detector = str(detector).strip() if detector is not None else None
        self.run = run
        self.update(rsd)

    @staticmethod
    def translate_source_dict(d):
        """Normalize raw settings: evaluate numeric expressions, parse the
        flavint group, compute total generated events
        (cf. reference ``mcSimRunSettings.py:149``)."""
        d = dict(d)
        for f in _NUMERIC_FIELDS:
            if f in d:
                d[f] = _eval_numeric(d[f])
        d["tot_gen"] = d["num_events_per_file"] * d["num_i3_files"]
        # ',' historically separated joined flavints; normalize to '+'
        flavints = d["flavints"]
        if isinstance(flavints, str):
            flavints = flavints.replace(",", "+")
        d["flavints"] = NuFlavIntGroup(flavints)
        return d

    def consistency_checks(self, data, flav=None):  # noqa: ARG002
        """Placeholder matching the reference API (reference also does
        nothing here, ``mcSimRunSettings.py:182``)."""

    def barnobarfract(
        self, barnobar=None, is_particle=None, flav_or_flavint=None
    ):
        """Fraction of generated events that are particles (or
        antiparticles), selected by exactly one of the three arguments
        (cf. reference ``mcSimRunSettings.py:186``)."""
        nargs = sum(
            x is not None for x in (barnobar, is_particle, flav_or_flavint)
        )
        if nargs != 1:
            raise ValueError(
                "One and only one of `barnobar`, `is_particle`, and"
                f" `flav_or_flavint` must be specified; got {nargs}"
            )
        if flav_or_flavint is not None:
            try:
                is_particle = NuFlavInt(flav_or_flavint).particle
            except ValueError:
                from pisa_tpu_torch.utils.flavint import NuFlav

                is_particle = NuFlav(flav_or_flavint).particle
        elif barnobar is not None:
            is_particle = barnobar > 0
        fract = self["nu_to_total_fract"]
        return fract if is_particle else 1.0 - fract

    def get_num_gen(
        self,
        barnobar=None,
        is_particle=None,
        flav_or_flavint=None,
        include_physical_fract=True,
    ):
        """Number of events generated, optionally restricted to particles /
        antiparticles and corrected by the GENIE physical fraction
        (cf. reference ``mcSimRunSettings.py:223``)."""
        nargs = sum(
            x is not None for x in (barnobar, is_particle, flav_or_flavint)
        )
        if flav_or_flavint is not None:
            fi = NuFlavInt(flav_or_flavint) if "_" in str(
                flav_or_flavint
            ) else None
            group = self["flavints"]
            if fi is not None:
                if fi not in group:
                    return 0
            else:
                from pisa_tpu_torch.utils.flavint import NuFlav

                if NuFlav(flav_or_flavint) not in group.flavs:
                    return 0
        fract = 1.0
        if nargs > 0:
            fract = self.barnobarfract(
                barnobar=barnobar,
                is_particle=is_particle,
                flav_or_flavint=flav_or_flavint,
            )
        physical = (
            self.get("physical_events_fract", 1.0)
            if include_physical_fract
            else 1.0
        )
        return self["tot_gen"] * fract * physical

    def get_flavints(self):
        return self["flavints"].get_flavints()

    def get_flavs(self):
        return self["flavints"].get_flavs()

    def get_energy_range(self):
        """(min, max) simulated energy in GeV."""
        return self["energy_min"], self["energy_max"]

    def get_spectral_index(self):
        """Simulated spectral index (positive for negative powers of E)."""
        return self["sim_spectral_index"]

    def get_xsec_version(self):
        return self["xsec_version"]

    def get_xsec(self, xsec=None):
        """Instantiated CrossSections for this run's version."""
        from pisa_tpu_torch.utils.cross_sections import CrossSections

        if xsec is None:
            return CrossSections(ver=self["xsec_version"])
        return CrossSections(ver=self["xsec_version"], xsec=xsec)


class DetMCSimRunsSettings(dict):
    """All runs' settings for one detector, keyed by run
    (cf. reference ``mcSimRunSettings.py:290``); each per-run query takes
    the run as its first argument."""

    def __init__(self, run_settings, detector=None):
        super().__init__()
        if isinstance(run_settings, str):
            from pisa_tpu_torch.utils.fileio import from_file
            from pisa_tpu_torch.utils.resources import find_resource

            run_settings = from_file(find_resource(run_settings))
        if not isinstance(run_settings, dict):
            raise TypeError(
                f"Unhandled run_settings type: {type(run_settings)}"
            )
        rsd = dict(run_settings)
        if detector is not None:
            matches = [
                k for k in rsd if str(k).lower() == str(detector).lower()
            ]
            if matches:
                rsd = rsd[matches[0]]
        elif len(rsd) == 1 and all(
            isinstance(v, dict) and "flavints" not in v for v in rsd.values()
        ):
            detector = next(iter(rsd))
            rsd = rsd[detector]
        self.detector = detector
        for run, d in rsd.items():
            self[str(run)] = MCSimRunSettings(d, run=run, detector=detector)

    def __getitem__(self, run):
        return super().__getitem__(str(run))

    def consistency_checks(self, data, run, flav=None):
        return self[run].consistency_checks(data, flav=flav)

    def barnobarfract(self, run, **kwargs):
        return self[run].barnobarfract(**kwargs)

    def get_num_gen(self, run, **kwargs):
        return self[run].get_num_gen(**kwargs)

    def get_flavints(self, run):
        return self[run].get_flavints()

    def get_flavs(self, run):
        return self[run].get_flavs()

    def get_energy_range(self, run):
        return self[run].get_energy_range()

    def get_spectral_index(self, run):
        return self[run].get_spectral_index()

    def get_xsec_version(self, run):
        return self[run].get_xsec_version()

    def get_xsec(self, run, xsec=None):
        return self[run].get_xsec(xsec=xsec)
