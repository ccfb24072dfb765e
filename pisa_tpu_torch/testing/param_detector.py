"""
The parameterized-detector study: truth -> parameterized effective area ->
parameterized reconstruction -> reco histogram, the path users run for
detector-design sensitivity studies.

It is ``settings/pipeline/osc_example.cfg`` (the toy events, barr_simple,
prob3 on PREM-12) carried to the reco binning:

    toy_event_generator -> barr_simple -> prob3 -> aeff.param
    -> reco.simple_param -> reco.resolutions -> utils.hist -> utils.fix_error

- ``data.toy_event_generator``: random events (``random = True``), 2e4 a
  category in 12 categories (240,000 events), calc and apply on events;
- ``flux.barr_simple`` on the events;
- ``osc.prob3`` on ``calc_grid`` (200 x 200) applied to the events,
  ``deltam31`` free beside ``theta23``;
- ``aeff.param`` with the ``vlvnt_aeff_{energy,coszen}_param.json``
  parameterizations, a livetime of one common year and ``aeff_scale`` free
  in [0, 3];
- ``reco.simple_param`` with the JAX package's ``init_test`` smearing, track
  PID 1 and cascade PID -1; ``reco.resolutions`` improving energy and
  coszen by 0.1 (PID 0);
- ``utils.hist`` to ``reco_binning`` (10 x 10 x 2 = 200 bins) with sumw2
  errors, then ``utils.fix_error``.

Free: ``delta_index``, ``theta23``, ``deltam31`` and ``aeff_scale``. The
stages run per container (of these services only hist and prob3 stack, as
in the JAX package). :func:`param_detector_text` gives the config's text,
:func:`write_param_detector` writes it, :func:`param_detector_config` parses
it (with ``small``: 2,000 events a category on ``calc_grid_coarse``) with
either package's parser.
"""

from __future__ import annotations

import os

from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["BASE_CFG", "param_detector_text", "write_param_detector",
           "param_detector_config"]

BASE_CFG = "settings/pipeline/osc_example.cfg"

_ORDER_FROM = "order = data.toy_event_generator, flux.barr_simple, osc.prob3\n"
_ORDER_TO = ("order = data.toy_event_generator, flux.barr_simple, osc.prob3,"
             " aeff.param, reco.simple_param, reco.resolutions, utils.hist,"
             " utils.fix_error\n")


def _edits(small):
    """(text in osc_example.cfg, its replacement), each found exactly
    once."""
    n_events, grid = ("2e3", "calc_grid_coarse") if small else ("2e4",
                                                                "calc_grid")
    return (
        (_ORDER_FROM, _ORDER_TO),
        ("output_binning = calc_grid\noutput_key = weights\n",
         "output_binning = reco_binning\noutput_key = weights, errors\n"),
        ("calc_mode = calc_grid\napply_mode = calc_grid\noutput_names",
         "calc_mode = events\napply_mode = events\noutput_names"),
        ("param.n_events = 1e4\n", f"param.n_events = {n_events}\n"),
        ("param.random = False\n", "param.random = True\n"),
        ("[flux.barr_simple]\n\ncalc_mode = calc_grid\n",
         "[flux.barr_simple]\n\ncalc_mode = events\napply_mode = events\n"),
        ("[osc.prob3]\n\ncalc_mode = calc_grid\napply_mode = calc_grid\n",
         f"[osc.prob3]\n\ncalc_mode = {grid}\napply_mode = events\n"),
        ("param.nh.deltam31.fixed = True\n",
         "param.nh.deltam31.fixed = False\n"),
    )


_AFTER_OSC = """
[aeff.param]

calc_mode = events
apply_mode = events

param.aeff_energy_paramfile = aeff/vlvnt_aeff_energy_param.json
param.aeff_coszen_paramfile = aeff/vlvnt_aeff_coszen_param.json
param.livetime = 1 * units.common_year
param.aeff_scale = 1.0
param.aeff_scale.fixed = False
param.aeff_scale.range = [0., 3.] * units.dimensionless
param.aeff_scale.prior = uniform

[reco.simple_param]

calc_mode = events
apply_mode = events

param.perfect_reco = False
param.reco_energy_params = {'*': [10., 0.2, 0.2]}
param.reco_coszen_params = {'*': [10., 0.3, -0.5]}
param.pid_track_params = {'*': [0.5, 0.2, 15.]}
param.track_pid = 1.0
param.cascade_pid = -1.0

[reco.resolutions]

calc_mode = events
apply_mode = events

param.energy_improvement = 0.1
param.coszen_improvement = 0.1
param.pid_improvement = 0.0

[utils.hist]

calc_mode = events
apply_mode = reco_binning
error_method = sumw2

[utils.fix_error]

calc_mode = reco_binning
apply_mode = reco_binning
"""


def param_detector_text(small=False):
    """The config's text; `small`: 2,000 events a category on
    ``calc_grid_coarse``."""
    with open(find_resource(BASE_CFG)) as f:
        text = f.read()
    for old, new in _edits(small):
        if text.count(old) != 1:
            raise ValueError(f"{BASE_CFG}: expected {old!r} once")
        text = text.replace(old, new)
    return text.rstrip("\n") + "\n" + _AFTER_OSC


def write_param_detector(path, small=False):
    """Writes the config to the file `path` (a directory: into it, as
    ``param_detector.cfg``); returns the file's path."""
    if os.path.isdir(path):
        path = os.path.join(path, "param_detector.cfg")
    with open(path, "w") as f:
        f.write(param_detector_text(small))
    return path


def param_detector_config(small=False, parse=None):
    """The parsed config; `parse` is the parser function of the package that
    will run it (by default the port's)."""
    import tempfile

    if parse is None:
        from pisa_tpu_torch.config.parser import parse_pipeline_config as parse
    with tempfile.TemporaryDirectory() as tmp:
        return parse(write_param_detector(tmp, small))
