"""
Parameterized effective areas (counterpart of
``pisa_tpu/stages/aeff/param.py``; reference ``pisa/stages/aeff/param.py``):
energy- and coszen-dependent effective-area parameterizations per flavint
group, loaded from JSON files holding either lambda-expression strings
(evaluated in a namespace of ``np`` alone) or (x, aeff) tables (linear
interpolation, zero outside).

As in the JAX package, flavint-group keys are matched to container names
through the flavint string algebra, and the per-event factor (it depends on
the events' truth only) is computed on the host in float64 at set-up and
cast once: the factors span many decades (the ντ CC table starts near
1e-9). Only ``aeff_scale * livetime`` stays a differentiable tensor in
apply.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
from scipy.interpolate import interp1d

from pisa_tpu_torch import FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.fileio import from_file
from pisa_tpu_torch.utils.flavint import NuFlavIntGroup

__all__ = ["param", "load_aeff_param", "init_test"]


def load_aeff_param(source):
    """An aeff parameterization: flavintgroup string -> callable (reference
    ``aeff/param.py:load_aeff_param``), from a file name or a mapping."""
    if isinstance(source, str):
        aeff_dict = from_file(source)
    elif isinstance(source, Mapping):
        aeff_dict = dict(source)
    else:
        raise TypeError("`source` must be string or mapping")

    out = {}
    for key, func in aeff_dict.items():
        if isinstance(func, str):
            out[key] = eval(  # noqa: S307 - namespace of np alone
                func, {"__builtins__": {}, "np": np}, {})
        elif callable(func):
            out[key] = func
        elif isinstance(func, Mapping):
            var = "energy" if "energy" in func else "coszen"
            if "aeff" not in func or var not in func:
                raise ValueError(f"bad aeff parameterization for {key!r}")
            out[key] = interp1d(func[var], func["aeff"], kind="linear",
                                bounds_error=False, fill_value=0)
        else:
            raise TypeError(
                f"cannot interpret aeff parameterization of type {type(func)}")
    return out


def _lookup_group(param_dict, container_name):
    """The parameterization whose flavint-group key contains the container's
    flavint (an exact name match first)."""
    if container_name in param_dict:
        return param_dict[container_name]
    for key, func in param_dict.items():
        try:
            if container_name in NuFlavIntGroup(key):
                return func
        except ValueError:
            continue
    return None


class param(Stage):  # noqa: N801
    """Params: aeff_energy_paramfile, aeff_coszen_paramfile, livetime,
    aeff_scale."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(
                "aeff_energy_paramfile",
                "aeff_coszen_paramfile",
                "livetime",
                "aeff_scale",
            ),
            expected_container_keys=("true_energy", "true_coszen", "weights"),
            **std_kwargs,
        )
        self.energy_param = load_aeff_param(
            str(self.params.aeff_energy_paramfile.value))
        self.coszen_param = load_aeff_param(
            str(self.params.aeff_coszen_paramfile.value))

    host_param_names = ("aeff_energy_paramfile", "aeff_coszen_paramfile")

    def setup_function(self):
        for container in self.data:
            factor = np.ones(container.size, dtype=np.float64)
            for table, key in ((self.energy_param, "true_energy"),
                               (self.coszen_param, "true_coszen")):
                func = _lookup_group(table, container.name)
                if func is not None:
                    factor = factor * np.asarray(
                        func(container[key].double().cpu().numpy()))
            container["aeff_param_factor"] = factor.astype(FTYPE)

    def apply_function(self):
        scale = in_data_type(self.params.aeff_scale.m_as("dimensionless")
                             * self.params.livetime.m_as("sec"))
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["aeff_param_factor"] * scale)


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([
        Param(name="aeff_energy_paramfile",
              value="aeff/vlvnt_aeff_energy_param.json", **param_kwargs),
        Param(name="aeff_coszen_paramfile",
              value="aeff/vlvnt_aeff_coszen_param.json", **param_kwargs),
        Param(name="livetime", value=10 * ureg.s, **param_kwargs),
        Param(name="aeff_scale", value=1.0, **param_kwargs),
    ])
    return param(params=param_set)
