"""
AIRS atmospheric-density systematic (counterpart of
``pisa_tpu/stages/flux/airs.py``; reference ``pisa/stages/flux/airs.py``):
per-event 1-sigma flux perturbation from a photospline table, scaled by
``airs_scale``.

Requires the external ``photospline`` package, imported when the service
is built (the reference's own service matrix skips this service too,
``pisa_tests/test_services.py:68``). Set-up evaluates the spline on the
host in float64 once per container; the apply is torch ops on the
containers' device, differentiable in ``airs_scale`` in a compiled
template. It runs per container, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["airs", "init_test"]


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class airs(Stage):  # noqa: N801
    """Parameters: airs_spline (photospline file); param airs_scale."""

    def __init__(self, airs_spline, **std_kwargs):
        try:
            import photospline
        except ImportError as exc:
            raise ImportError(
                "flux.airs requires the external 'photospline' package,"
                " which is not installed in this environment."
            ) from exc
        self.airs_spline = photospline.SplineTable(
            find_resource(airs_spline)
        )
        super().__init__(
            expected_params=("airs_scale",),
            expected_container_keys=(
                "true_energy", "true_coszen", "weights",
            ),
            **std_kwargs,
        )

    def setup_function(self):
        for container in self.data:
            if container.size == 0:
                container["airs_1s_perturb"] = np.zeros(0)
            else:
                container["airs_1s_perturb"] = np.asarray(
                    self.airs_spline.evaluate_simple((
                        np.log10(_host(container["true_energy"])),
                        _host(container["true_coszen"]),
                    )),
                    dtype=np.float64,
                )

    def apply_function(self):
        scale = in_data_type(self.params.airs_scale.m_as("dimensionless"))
        for container in self.data:
            container["weights"] = container["weights"] * (
                1.0 + container["airs_1s_perturb"] * scale
            )


def init_test(**param_kwargs):
    """Instantiation example (skipped: photospline + spline file absent)."""
    import pytest

    pytest.importorskip("photospline")
    param_set = ParamSet(
        [Param(name="airs_scale", value=1.0, **param_kwargs)]
    )
    return airs(airs_spline="airs_spline.txt", params=param_set)
