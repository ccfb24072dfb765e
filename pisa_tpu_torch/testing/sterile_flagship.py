"""
The 3+1 variant of the IceCube 3-year flagship pipeline: a sterile search
on the atmospheric sample, as IceCube's DeepCore 3-year sterile analysis
(Phys. Rev. D 95, 112002 (2017)) fits theta24 and theta34 with Delta
m^2_41 = 1 eV^2 and the fast oscillations averaged.

It is ``settings/pipeline/IceCube_3y_neutrinos.cfg`` (240k events, 12
categories, the 200x200 ``true_allsky_fine`` grid, 8x8x2 output bins) with
``[osc.prob3]`` replaced by ``[osc.nusquids]``: ``num_neutrinos = 4``, the
low-pass filter of ``sterile_example.cfg`` (cutoff 0.04 / km, fraction
0.1), the flagship's Earth model and 3-flavour parameters with their fixed
and free states, theta24 free in 0-30 deg at 8 deg (``sterile_example
.cfg``'s nominal), theta34 free in 0-30 deg at 0, and theta14 = 0, Delta
m^2_41 = 1 eV^2, delta14 = delta24 = 0 fixed: 17 free parameters.

:func:`write_sterile_flagship` writes it as a config file; with
:func:`sterile_flagship_config` the parsed config, optionally cut to a
small grid and a fraction of the events (either package's parser). Both
also make the 3-flavour ``osc.nusquids`` variant of the flagship, whose
physics is prob3's.
"""

from __future__ import annotations

import os

from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["FLAGSHIP_CFG", "STERILE_PARAMS", "sterile_flagship_text",
           "write_sterile_flagship", "sterile_flagship_config"]

FLAGSHIP_CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"

#: the lines that turn [osc.prob3] into the 3+1 [osc.nusquids]
STERILE_PARAMS = """\
num_neutrinos = 4
prop_lowpass_cutoff = 0.04
prop_lowpass_frac = 0.1

param.theta14 = 0.0 * units.degree
param.theta14.fixed = True

param.theta24 = 8.0 * units.degree
param.theta24.fixed = False
param.theta24.range = [0., 30.] * units.degree
param.theta24.prior = uniform

param.theta34 = 0.0 * units.degree
param.theta34.fixed = False
param.theta34.range = [0., 30.] * units.degree
param.theta34.prior = uniform

param.deltam41 = 1.0 * units.eV**2
param.deltam41.fixed = True

param.deltacp14 = 0.0 * units.degree
param.deltacp14.fixed = True

param.deltacp24 = 0.0 * units.degree
param.deltacp24.fixed = True
"""


def sterile_flagship_text(num_neutrinos=4):
    """The config's text: the flagship's with its oscillation stage made the
    3+1 ``osc.nusquids``; with `num_neutrinos` = 3, the 3-flavour
    ``osc.nusquids`` with prob3's parameters (the same physics as the
    flagship itself)."""
    with open(find_resource(FLAGSHIP_CFG)) as f:
        text = f.read()
    if text.count("osc.prob3") != 2:
        raise ValueError(f"{FLAGSHIP_CFG}: expected osc.prob3 in the order and"
                         " as one section")
    lines = STERILE_PARAMS if num_neutrinos == 4 else "num_neutrinos = 3\n"
    text = text.replace("[osc.prob3]\n", "[osc.nusquids]\n\n" + lines, 1)
    return text.replace("osc.prob3", "osc.nusquids", 1)


def write_sterile_flagship(directory, num_neutrinos=4):
    """Writes the config into `directory`; returns its path."""
    path = os.path.join(directory,
                        f"IceCube_3y_neutrinos_nusquids{num_neutrinos}.cfg")
    with open(path, "w") as f:
        f.write(sterile_flagship_text(num_neutrinos))
    return path


def sterile_flagship_config(directory, grid_bins=None, fraction=None,
                            parse=None, binning=None, ureg=None,
                            num_neutrinos=4):
    """The parsed config (written into `directory` first; `num_neutrinos`
    as for :func:`sterile_flagship_text`): with `grid_bins`,
    the ``true_allsky_fine`` grid cut to grid_bins x grid_bins (1-1000 GeV
    log, coszen -1..1); with `fraction`, the loader keeps that fraction of
    the events. `parse`, `binning` and `ureg` are the parser function, the
    binning module and the unit registry of the package that will run it
    (by default the port's)."""
    if parse is None:
        from pisa_tpu_torch import ureg
        from pisa_tpu_torch.config.parser import parse_pipeline_config as parse
        from pisa_tpu_torch.core import binning
    config = parse(write_sterile_flagship(directory, num_neutrinos))
    if fraction is not None:
        config[("data", "csv_loader")]["fraction_events_to_keep"] = fraction
    if grid_bins is not None:
        grid = binning.MultiDimBinning(
            [
                binning.OneDimBinning(
                    "true_energy", num_bins=grid_bins, is_log=True,
                    domain=[1, 1000] * ureg.GeV,
                ),
                binning.OneDimBinning(
                    "true_coszen", num_bins=grid_bins, is_lin=True,
                    domain=[-1, 1],
                ),
            ],
            name="true_allsky_fine",
        )
        for key, settings in config.items():
            if isinstance(key, tuple):
                for mode in ("calc_mode", "apply_mode"):
                    if getattr(settings.get(mode), "name", None) == grid.name:
                        settings[mode] = grid
    return config
