"""
Host copy of ``pisa_tpu/analysis/manipulate_params.py`` with its imports
rewritten to ``pisa_tpu_torch``.

Param-manipulation helpers for fit strategies
(cf. reference ``pisa/analysis/manipulate_params.py``).
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import ureg
from pisa_tpu_torch.utils.log import logging

__all__ = [
    "get_separate_octant_params",
    "update_param_values",
    "BoundedRandomDisplacement",
]


def get_separate_octant_params(
    hypo_maker, angle_name, inflection_point, tolerance=None
):
    """Prepare (first_octant_param_state, second_octant_param_state) for an
    octant-split fit of `angle_name` around `inflection_point` (typically 45
    deg for theta23); cf. reference ``manipulate_params.py:44``.

    Returns the param object plus the two (value, range) alternatives; the
    caller restores the original range afterwards.
    """
    angle = hypo_maker.params[angle_name]
    if tolerance is None:
        tolerance = 1.0 * ureg.degree
    inflection = inflection_point.to(angle.units)
    tol = tolerance.to(angle.units)

    orig_value = angle.value
    orig_range = angle.range

    lo, hi = angle.range
    # first-octant case: range capped at inflection (+ tolerance)
    first_range = (lo, min(hi, inflection + tol))
    # second-octant case: range floored at inflection (- tolerance)
    second_range = (max(lo, inflection - tol), hi)

    # starting value mirrored around the inflection point
    mirrored = 2 * inflection - orig_value.to(angle.units)
    v = orig_value.to(angle.units)
    if v <= inflection:
        first_value = v
        second_value = min(max(mirrored, second_range[0]), second_range[1])
    else:
        first_value = min(max(mirrored, first_range[0]), first_range[1])
        second_value = v

    return dict(
        angle=angle,
        orig_value=orig_value,
        orig_range=orig_range,
        first=(first_value, first_range),
        second=(second_value, second_range),
    )


def update_param_values(hypo_maker, params, update_nominal_values=False,
                        update_range=False, update_is_fixed=False):
    """Copy values (and optionally ranges/fixed states) from `params` into the
    same-named params of `hypo_maker` (cf. reference
    ``manipulate_params.py:125``)."""
    from pisa_tpu_torch.core.param import Param

    if isinstance(params, Param):
        params = [params]
    for p in params:
        if p.name not in hypo_maker.params:
            logging.debug("Param %s not in hypo maker; skipped", p.name)
            continue
        target = hypo_maker.params[p.name]
        if update_range and p.range is not None:
            target.range = p.range
        target.value = p.value
        if update_nominal_values:
            target.nominal_value = p.nominal_value
        if update_is_fixed:
            target.is_fixed = p.is_fixed


class BoundedRandomDisplacement:
    """Take-step callable for scipy basinhopping: uniform displacement
    clipped to bounds (cf. reference ``manipulate_params.py:18``)."""

    def __init__(self, stepsize=0.5, bounds=(0, 1), random_state=None):
        self.stepsize = stepsize
        self.bounds = bounds
        self.rng = np.random.RandomState(
            random_state if isinstance(random_state, int) else None
        )

    def __call__(self, x):
        x = x + self.rng.uniform(
            -self.stepsize, self.stepsize, np.shape(x)
        )
        return np.clip(x, *self.bounds)
