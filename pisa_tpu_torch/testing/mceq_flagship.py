"""
The MCEq-Barr variant of the IceCube 3-year flagship pipeline: the flux,
cross-section and absorption services that IceCube oscillation analyses
put between the loader and the histogram.

It is ``settings/pipeline/IceCube_3y_neutrinos.cfg`` (240k events, 12
categories, the 200x200 ``true_allsky_fine`` grid, 8x8x2 output bins) with
``[flux.barr_simple]`` replaced by ``[flux.mceq_barr]`` on honda_ip's
nominal flux (``use_honda_nominal_flux = True``, the SIBYLL23C gradient
table), and ``absorption.earth_absorption`` (PREM-12) and
``xsec.nutau_xsec`` after ``osc.prob3``:

    csv_loader -> honda_ip -> mceq_barr -> prob3 -> earth_absorption
    -> nutau_xsec -> aeff -> hist -> hypersurfaces

mceq_barr frees its 18 Barr parameters and ``delta_index``: the Barr
blocks at 0 with the uncertainties of Barr et al. (Phys. Rev. D 74,
094009, 2006), ranges nominal +- 3 sigma, the pion ratio at 0 +- 0.1 and
``delta_index`` at 0 +- 0.1 as the flagship's barr_simple has it; the
pivot is barr_simple's 24.09 GeV. ``nutau_xsec_scale`` is free in [0, 2]
at 1, the model that the JAX package's ``init_test`` uses: at 0 the JAX
package's scale is NaN for ντ CC events below the tau threshold (0 x -inf,
``stages/xsec/nutau_xsec.py``), which the flagship's events reach (1.5
GeV), so both packages are defined only away from it. With the flagship's
other free parameters that makes 30.

:func:`write_mceq_flagship` writes it as a config file; with
:func:`mceq_flagship_config` the parsed config, optionally cut to a small
grid and a fraction of the events (either package's parser). The stages
run per container (none of the new services stacks, as in the JAX
package).
"""

from __future__ import annotations

import os

from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["FLAGSHIP_CFG", "BARR_SIGMAS", "mceq_flagship_text",
           "write_mceq_flagship", "mceq_flagship_config"]

FLAGSHIP_CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"

#: Barr et al. (2006) uncertainty of each block: pions a-i, kaons w-z (the
#: antikaon blocks take the kaons')
BARR_SIGMAS = {
    "a": 0.1, "b": 0.3, "c": 0.4, "d": 0.3, "e": 0.05, "f": 0.1, "g": 0.3,
    "h": 0.15, "i": 0.122, "w": 0.4, "x": 0.1, "y": 0.3, "z": 0.122,
}

_ORDER_FROM = "flux.barr_simple, osc.prob3,"
_ORDER_TO = ("flux.mceq_barr, osc.prob3, absorption.earth_absorption,"
             " xsec.nutau_xsec,")


def _param(name, nominal, sigma, lo, hi):
    return (f"param.{name} = {nominal} +/- {sigma}\n"
            f"param.{name}.fixed = False\n"
            f"param.{name}.range = nominal + [{lo}, +{hi}] * sigma\n\n")


def _mceq_section():
    text = ("[flux.mceq_barr]\n\n"
            "calc_mode = true_allsky_fine\n\n"
            "table_file = flux/MCEq_flux_gradient_splines_2212_"
            "GlobalSplineFitBeta_SIBYLL23C.pckl.bz2\n"
            "use_honda_nominal_flux = True\n"
            "include_nutau_flux = False\n\n")
    text += _param("delta_index", 0.0, 0.1, -5, 5)
    text += "param.energy_pivot = 24.0900951261 * units.GeV\n"
    text += "param.energy_pivot.fixed = True\n\n"
    text += _param("pion_ratio", 0.0, 0.1, -3, 3)
    for n in "abcdefghi":
        text += _param(f"barr_{n}_Pi", 0.0, BARR_SIGMAS[n], -3, 3)
    for n in "wxyz":
        for kind in ("K", "antiK"):
            text += _param(f"barr_{n}_{kind}", 0.0, BARR_SIGMAS[n], -3, 3)
    return text


_AFTER_OSC = """\
[absorption.earth_absorption]

calc_mode = true_allsky_fine
apply_mode = events

earth_model = osc/PREM_12layer.dat
detector_depth = ${earth:detector_depth}
prop_height = ${earth:prop_height}

[xsec.nutau_xsec]

calc_mode = events
apply_mode = events

param.nutau_xsec_scale = 1.0
param.nutau_xsec_scale.fixed = False
param.nutau_xsec_scale.range = [0., 2.] * units.dimensionless
param.nutau_xsec_scale.prior = uniform

"""


def mceq_flagship_text():
    """The config's text: the flagship's with the stages above."""
    with open(find_resource(FLAGSHIP_CFG)) as f:
        text = f.read()
    if text.count(_ORDER_FROM) != 1 or text.count("[flux.barr_simple]") != 1:
        raise ValueError(f"{FLAGSHIP_CFG}: expected barr_simple before prob3"
                         " in the order and as one section")
    text = text.replace(_ORDER_FROM, _ORDER_TO, 1)
    start = text.index("[flux.barr_simple]")
    end = text.index("[osc.prob3]")
    text = text[:start] + _mceq_section() + text[end:]
    start = text.index("[aeff.aeff]")
    return text[:start] + _AFTER_OSC + text[start:]


def write_mceq_flagship(directory):
    """Writes the config into `directory`; returns its path."""
    path = os.path.join(directory, "IceCube_3y_neutrinos_mceq.cfg")
    with open(path, "w") as f:
        f.write(mceq_flagship_text())
    return path


def mceq_flagship_config(directory, grid_bins=None, fraction=None,
                         parse=None, binning=None, ureg=None):
    """The parsed config (written into `directory` first): with
    `grid_bins`, the ``true_allsky_fine`` grid cut to grid_bins x grid_bins
    (1-1000 GeV log, coszen -1..1); with `fraction`, the loader keeps that
    fraction of the events. `parse`, `binning` and `ureg` are the parser
    function, the binning module and the unit registry of the package that
    will run it (by default the port's)."""
    if parse is None:
        from pisa_tpu_torch import ureg
        from pisa_tpu_torch.config.parser import parse_pipeline_config as parse
        from pisa_tpu_torch.core import binning
    config = parse(write_mceq_flagship(directory))
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
