"""
Toy event generator stage (counterpart of
``pisa_tpu/stages/data/toy_event_generator.py``; reference
``pisa/stages/data/toy_event_generator.py``): random events, or the points
of a binned calc mode, with unit weights and a (0, 1) nominal (nue, numu)
flux, one container per output name.

The random numbers come from ``np.random.RandomState(seed)`` in the
reference's order, so both packages generate the same events.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.container import Container
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage

__all__ = ["toy_event_generator", "init_test"]


class toy_event_generator(Stage):  # noqa: N801
    """Generate toy events (or grid points) for the `output_names`
    categories. Params: n_events, random, seed."""

    def __init__(self, output_names, **std_kwargs):
        self.output_names = output_names
        super().__init__(
            expected_params=("n_events", "random", "seed"),
            expected_container_keys=(),
            **std_kwargs,
        )

    def setup_function(self):
        n_events = int(self.params.n_events.value.magnitude)
        seed = int(self.params.seed.value.magnitude)
        random_state = np.random.RandomState(seed)

        for name in self.output_names:
            container = Container(name, representation=self.calc_mode,
                                  device=self.data.device)
            nubar = -1 if "bar" in name else 1
            if "e" in name:
                flav = 0
            if "mu" in name:
                flav = 1
            if "tau" in name:
                flav = 2

            if not isinstance(self.calc_mode, MultiDimBinning):
                container["true_energy"] = np.power(
                    10, random_state.rand(n_events).astype(FTYPE) * 3
                )
                container["true_coszen"] = (
                    random_state.rand(n_events).astype(FTYPE) * 2 - 1
                )

            size = container.size
            if self.params.random.value:
                container["initial_weights"] = random_state.rand(size).astype(
                    FTYPE
                )
            else:
                container["initial_weights"] = np.ones(size, dtype=FTYPE)

            container.set_aux_data("nubar", nubar)
            container.set_aux_data("flav", flav)
            container["weights"] = np.ones(size, dtype=FTYPE)
            container["weighted_aeff"] = np.ones(size, dtype=FTYPE)

            flux = np.stack(
                [np.zeros(size, dtype=FTYPE), np.ones(size, dtype=FTYPE)],
                axis=1,
            )
            container["nu_flux_nominal"] = flux
            container["nubar_flux_nominal"] = flux

            self.data.add_container(container)

    def apply_function(self):
        for container in self.data:
            # a fresh tensor: the template's state swap keeps the old one
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="n_events", value=100, **param_kwargs),
            Param(name="random", value=1, **param_kwargs),
            Param(name="seed", value=666, **param_kwargs),
        ]
    )
    return toy_event_generator(
        output_names=["numu", "nue_bar"], params=param_set,
        calc_mode="events",
    )
