"""
Bootstrap resampling (counterpart of ``pisa_tpu/stages/utils/bootstrap.py``;
reference ``pisa/stages/utils/bootstrap.py``): a resample with replacement,
drawn at set-up, as per-event multiplicity weights (an event drawn twice
weighs 2).

The draw is numpy's, on the host: ``np.random.default_rng(seed).integers``
over the containers in turn, as the JAX package draws it, so both give the
same counts; the counts are then uploaded to the containers' device.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.log import logging

__all__ = ["bootstrap", "init_test"]


class bootstrap(Stage):  # noqa: N801
    """Parameters: seed (int, optional). Events calc mode."""

    def __init__(self, seed=None, **std_kwargs):
        super().__init__(
            expected_params=(),
            expected_container_keys=("weights",),
            **std_kwargs,
        )
        self.seed = None if seed is None else int(seed)

    def setup_function(self):
        logging.debug("Setting up bootstrap with seed: %s", self.seed)
        rng = np.random.default_rng(self.seed)
        for container in self.data:
            n = container.size
            idx = rng.integers(n, size=n)
            container["bootstrap_weights"] = np.bincount(
                idx, minlength=n).astype(FTYPE)

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["bootstrap_weights"])


def init_test(**param_kwargs):
    """Instantiation example."""
    return bootstrap(calc_mode="events")
