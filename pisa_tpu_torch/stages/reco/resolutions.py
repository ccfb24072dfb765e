"""
Resolution-improvement study (counterpart of
``pisa_tpu/stages/reco/resolutions.py``; reference
``pisa/stages/reco/resolutions.py``): at set-up, moves reco_energy and
reco_coszen the given fraction of the way to the truth (coszen clamped to
[-1, 1]) and shifts the PID: up for the track-like numu(bar) CC events,
down for the others (``relative_pid``: the fraction of the way to 1 or 0).
Torch ops on the containers' device.
"""

from __future__ import annotations

import torch

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage

__all__ = ["resolutions", "init_test"]


class resolutions(Stage):  # noqa: N801
    """Params: energy_improvement, coszen_improvement, pid_improvement."""

    def __init__(self, relative_pid=False, **std_kwargs):
        super().__init__(
            expected_params=(
                "energy_improvement",
                "coszen_improvement",
                "pid_improvement",
            ),
            expected_container_keys=(
                "true_energy", "true_coszen", "reco_energy", "reco_coszen",
                "pid",
            ),
            **std_kwargs,
        )
        self.relative_pid = relative_pid

    def setup_function(self):
        e_imp = self.params.energy_improvement.m_as("dimensionless")
        cz_imp = self.params.coszen_improvement.m_as("dimensionless")
        pid_imp = self.params.pid_improvement.m_as("dimensionless")

        for container in self.data:
            container["reco_energy"] = container["reco_energy"] + (
                container["true_energy"] - container["reco_energy"]) * e_imp
            container["reco_coszen"] = torch.clamp(
                container["reco_coszen"]
                + (container["true_coszen"] - container["reco_coszen"])
                * cz_imp, -1, 1)

            # track-like (numu CC) events shift up, the others down
            pid = container["pid"]
            target = 1 if container.name in ("numu_cc", "numubar_cc") else 0
            if self.relative_pid:
                pid = pid + (target - pid) * pid_imp
            elif target:
                pid = pid + pid_imp
            else:
                pid = pid - pid_imp
            container["pid"] = pid


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([
        Param(name="energy_improvement", value=0.9, **param_kwargs),
        Param(name="coszen_improvement", value=0.5, **param_kwargs),
        Param(name="pid_improvement", value=0.02, **param_kwargs),
    ])
    return resolutions(params=param_set)
