"""
Parameterized reconstruction (counterpart of
``pisa_tpu/stages/reco/simple_param.py``; reference
``pisa/stages/reco/simple_param.py``): reco_energy, reco_coszen and pid
drawn at set-up from the truth through simple particle- and
energy-dependent smearing. The param dicts are parsed with
``ast.literal_eval``.

The draws are numpy's, on the host, in the JAX package's order: one
``np.random.RandomState(0)`` over the containers in turn, for each a normal
draw for the energy, a normal draw for coszen and a uniform draw for the
PID. So both packages give the same reco variables bit for bit; the
results are then uploaded to the containers' device.
"""

from __future__ import annotations

import ast
import fnmatch

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage

__all__ = [
    "simple_param",
    "logistic_function",
    "has_muon",
    "visible_energy_correction",
    "energy_dependent_sigma",
    "simple_reco_energy_parameterization",
    "simple_reco_coszen_parameterization",
    "simple_pid_parameterization",
    "init_test",
]


def dict_lookup_wildcard(dict_obj, key):
    """(key, value) of the one (wildcard) dict key matching `key`
    (reference ``simple_param.py:49``)."""
    matches = {k: v for k, v in dict_obj.items() if fnmatch.fnmatch(key, k)}
    if not matches:
        raise KeyError(f"no match for {key!r}")
    if len(matches) > 1:
        raise KeyError(f"multiple matches for {key!r}: {list(matches)}")
    ((k, v),) = matches.items()
    return k, v


def logistic_function(a, b, c, x):
    """a / (1 + exp(-b (x - c)))."""
    return a / (1.0 + np.exp(-b * (x - c)))


def has_muon(particle_key):
    """True for final states with muons (numu CC, atmospheric muons)."""
    return (particle_key.startswith("numu") and particle_key.endswith("_cc")
            ) or particle_key.startswith("muon")


def visible_energy_correction(particle_key):
    """Crude visible-energy fraction per particle type (reference
    ``simple_param.py:126``)."""
    if particle_key.endswith("_nc"):
        return 0.4
    if particle_key.startswith("nutau") and particle_key.endswith("_cc"):
        return 0.6
    if particle_key == "muons":
        return 0.1
    return 1.0


def energy_dependent_sigma(energy, energy_0, sigma_0, energy_power):
    """sigma(E) = sigma_0 (E/E0)^n."""
    return sigma_0 * np.power(energy / energy_0, energy_power)


def simple_reco_energy_parameterization(particle_key, true_energy, params,
                                        random_state):
    """Smeared reco energy (reference ``simple_param.py:198``)."""
    if random_state is None:
        random_state = np.random.RandomState()
    visible = np.asarray(true_energy) * visible_energy_correction(
        particle_key)
    _, (e0, sigma0, power) = dict_lookup_wildcard(params, particle_key)
    sigma = energy_dependent_sigma(visible, e0, sigma0, power)
    reco = visible * (random_state.normal(np.zeros_like(sigma), sigma) + 1.0)
    reco[reco < 0.0] = 0.0
    return reco


def simple_reco_coszen_parameterization(particle_key, true_energy,
                                        true_coszen, params, random_state):
    """Smeared reco coszen, reflected at the bounds (reference
    ``simple_param.py:259``)."""
    if random_state is None:
        random_state = np.random.RandomState()
    visible = np.asarray(true_energy) * visible_energy_correction(
        particle_key)
    _, (e0, sigma0, power) = dict_lookup_wildcard(params, particle_key)
    sigma = energy_dependent_sigma(visible, e0, sigma0, power)
    reco = np.asarray(true_coszen) + random_state.normal(
        np.zeros_like(sigma), sigma)
    over = reco > 1.0
    reco[over] -= 2.0 * (reco[over] - 1.0)
    under = reco < -1.0
    reco[under] -= 2.0 * (reco[under] + 1.0)
    return reco


def simple_pid_parameterization(particle_key, true_energy, params, track_pid,
                                cascade_pid, random_state):
    """PID from a logistic track probability (reference
    ``simple_param.py:323``)."""
    if random_state is None:
        random_state = np.random.RandomState()
    _, (a, b, c) = dict_lookup_wildcard(params, particle_key)
    track_prob = logistic_function(a, b, c, np.asarray(true_energy))
    is_track = random_state.uniform(0.0, 1.0, size=np.size(true_energy)
                                    ) < track_prob
    return np.where(is_track, track_pid, cascade_pid).astype(FTYPE)


class simple_param(Stage):  # noqa: N801
    """Params: perfect_reco, reco_energy_params, reco_coszen_params,
    pid_track_params, track_pid, cascade_pid."""

    def __init__(self, **std_kwargs):
        super().__init__(
            expected_params=(
                "perfect_reco",
                "reco_energy_params",
                "reco_coszen_params",
                "pid_track_params",
                "track_pid",
                "cascade_pid",
            ),
            expected_container_keys=("true_energy", "true_coszen"),
            **std_kwargs,
        )

    def setup_function(self):
        def parse(v):
            return ast.literal_eval(v) if isinstance(v, str) else v

        perfect_reco = bool(self.params.perfect_reco.value)
        reco_energy_params = parse(self.params.reco_energy_params.value)
        reco_coszen_params = parse(self.params.reco_coszen_params.value)
        pid_track_params = parse(self.params.pid_track_params.value)
        track_pid = self.params.track_pid.value.m_as("dimensionless")
        cascade_pid = self.params.cascade_pid.value.m_as("dimensionless")

        # a fixed seed: the same smearing for the template and pseudodata
        random_state = np.random.RandomState(0)

        for container in self.data:
            key = container.name
            true_energy = container["true_energy"].cpu().numpy()
            true_coszen = container["true_coszen"].cpu().numpy()

            if perfect_reco:
                reco_energy = true_energy.copy()
                reco_coszen = true_coszen.copy()
                pid = np.full_like(
                    true_energy, track_pid if has_muon(key) else cascade_pid)
            else:
                reco_energy = simple_reco_energy_parameterization(
                    key, true_energy, reco_energy_params, random_state)
                reco_coszen = simple_reco_coszen_parameterization(
                    key, true_energy, true_coszen, reco_coszen_params,
                    random_state)
                pid = simple_pid_parameterization(
                    key, true_energy, pid_track_params, track_pid,
                    cascade_pid, random_state)

            container["reco_energy"] = reco_energy.astype(FTYPE)
            container["reco_coszen"] = reco_coszen.astype(FTYPE)
            container["pid"] = pid.astype(FTYPE)


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet([
        Param(name="perfect_reco", value=False, **param_kwargs),
        Param(name="reco_energy_params", value="{'*': [10., 0.2, 0.2]}",
              **param_kwargs),
        Param(name="reco_coszen_params", value="{'*': [10., 0.3, -0.5]}",
              **param_kwargs),
        Param(name="pid_track_params", value="{'*': [0.5, 0.2, 15.]}",
              **param_kwargs),
        Param(name="track_pid", value=1.0, **param_kwargs),
        Param(name="cascade_pid", value=0.0, **param_kwargs),
    ])
    return simple_param(params=param_set)
