"""
Generic weight scaling (counterpart of ``pisa_tpu/stages/aeff/weight.py``;
reference ``pisa/stages/aeff/weight.py``): ``weights *= weight_scale *
livetime``, and the errors too where the container holds them. Both
parameters stay differentiable.
"""

from __future__ import annotations

from pisa_tpu_torch import ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type

__all__ = ["weight", "init_test"]


class weight(Stage):  # noqa: N801
    """Params: livetime, weight_scale."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=("livetime", "weight_scale"),
            expected_container_keys=("weights",),
            **std_kwargs,
        )

    def apply_function(self):
        scale = in_data_type(self.params.weight_scale.m_as("dimensionless")
                             * self.params.livetime.m_as("sec"))
        for container in self.data:
            container["weights"] = container["weights"] * scale
            if "errors" in container.keys:
                container["errors"] = container["errors"] * scale


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([
        Param(name="livetime", value=3 * ureg.year, **param_kwargs),
        Param(name="weight_scale", value=1.0, **param_kwargs),
    ])
    return weight(params=param_set)
