"""
Ad-hoc data/MC agreement correction (counterpart of
``pisa_tpu/stages/utils/adhoc_sys.py``; reference
``pisa/stages/utils/adhoc_sys.py``): per-variable scale factors from a JSON
file holding a 1-D binning and an array of factors, set in that binning at
set-up and looked up per event at every apply.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.fileio import from_file
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["adhoc_sys", "init_test"]


class adhoc_sys(Stage):  # noqa: N801
    """Parameters: variable_name, scale_file. Events calc and apply
    modes."""

    def __init__(self, variable_name=None, scale_file=None, **std_kwargs):
        super().__init__(
            expected_params=(),
            expected_container_keys=("weights", variable_name),
            **std_kwargs,
        )
        self.variable = variable_name
        self.scale_file = scale_file

    def setup_function(self):
        path = find_resource(self.scale_file)
        logging.info("Loading scaling factors from: %s", path)
        entry = from_file(path)[self.variable]
        binning = entry["binning"]
        if isinstance(binning, dict):
            binning = MultiDimBinning.from_state(binning)
        factors = np.asarray(entry["scales"], dtype=FTYPE)

        self.data.representation = binning
        for container in self.data:
            container["adhoc_scale_factors"] = factors

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["adhoc_scale_factors"])


def init_test(**param_kwargs):
    """Instantiation example: the JAX package's scale file, written into the
    temporary directory."""
    from pisa_tpu_torch.core.binning import OneDimBinning
    from pisa_tpu_torch.utils.fileio import to_file

    var = "reco_length"
    binning = MultiDimBinning(
        [OneDimBinning(var, bin_edges=[0, 0.5, 1.0], is_lin=True)],
        name="adhoc_sys_test_binning",
    )
    scales = np.random.RandomState(0).random(2).astype(FTYPE)
    path = os.path.join(tempfile.gettempdir(),
                        f"pisa_tpu_torch_test_scale_file_{os.getpid()}.json")
    to_file({var: {"binning": binning.state, "scales": scales}}, path)
    return adhoc_sys(variable_name=var, scale_file=path,
                     calc_mode="events", apply_mode="events")
