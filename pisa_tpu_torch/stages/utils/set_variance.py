"""
Override binned variances (counterpart of
``pisa_tpu/stages/utils/set_variance.py``; reference
``pisa/stages/utils/set_variance.py``): the manual variance is weights x
``variance_scale`` (times expected / actual MC events with
``divide_total_mc``, floored at ``variance_floor``), and the errors its
square root.

The variance is taken from the weights of the first evaluation after
set-up and kept, on the eager route and in a compiled template alike, as
the reference's params-hash cache keeps the compute of a stage without
params (and as ``utils.fix_error`` keeps its errors). The JAX stage's
compute never runs (its ``Stage.compute`` returns at once for a stage with
neither params nor expected container keys), so its errors are the square
root of the uninitialized array its set-up allocates.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.log import logging

__all__ = ["set_variance", "init_test"]


class set_variance(Stage):  # noqa: N801
    """Parameters: variance_scale, variance_floor, expected_total_mc,
    divide_total_mc. Binned calc and apply modes."""

    def __init__(self, variance_scale=1.0, variance_floor=None,
                 expected_total_mc=None, divide_total_mc=False,
                 **std_kwargs):
        super().__init__(
            expected_params=(),
            expected_container_keys=("weights",),
            **std_kwargs,
        )
        for mode in (self.calc_mode, self.apply_mode):
            if not isinstance(mode, MultiDimBinning):
                raise ValueError("set_variance needs binned calc and apply"
                                 f" modes, not {mode!r}")
        if variance_scale is None:
            raise ValueError("variance_scale must be given")
        self.variance_scale = float(variance_scale)
        self.variance_floor = (
            None if variance_floor is None else float(variance_floor))
        if expected_total_mc is None:
            raise ValueError("expected_total_mc must be given")
        self.expected_total_mc = int(expected_total_mc)
        self.divide_n = bool(divide_total_mc)
        self.total_mc = {}
        #: container name -> the kept variance (None: not taken yet)
        self.manual_variance = None

    def setup_function(self):
        if self.divide_n:
            self.data.representation = "events"
            for container in self.data:
                self.total_mc[container.name] = container.size
                logging.debug("%d mc events in container %s",
                              container.size, container.name)
        self.data.representation = self.calc_mode
        for container in self.data:
            if "errors" not in container.keys:
                container["errors"] = np.zeros(container.size)
        self.manual_variance = None

    def compute_function(self):
        if self.manual_variance is not None:
            return
        kept = {}
        for container in self.data:
            var = container["weights"].detach() * self.variance_scale
            if container.lanes is not None:
                var = var[0]
            if self.divide_n:
                var = var * (self.expected_total_mc
                             / self.total_mc[container.name])
            if self.variance_floor is not None:
                var = torch.clamp(var, min=self.variance_floor)
            kept[container.name] = var
        self.manual_variance = kept

    def apply_function(self):
        for container in self.data:
            var = self.manual_variance[container.name]
            container["manual_variance"] = var if container.lanes is None \
                else var.expand((container.lanes,) + var.shape)
            container["errors"] = torch.sqrt(container["manual_variance"])


def init_test(**param_kwargs):
    """Instantiation example."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.binning import OneDimBinning

    binning = MultiDimBinning(
        [OneDimBinning("true_energy", num_bins=5, is_log=True,
                       domain=[1, 100] * ureg.GeV)],
        name="test",
    )
    return set_variance(expected_total_mc=100, calc_mode=binning,
                        apply_mode=binning)
