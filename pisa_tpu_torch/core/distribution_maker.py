"""
DistributionMaker: one or more pipelines whose outputs sum to the
hypothesis template (counterpart of ``pisa_tpu/core/distribution_maker.py``;
reference ``pisa/core/distribution_maker.py:49``).

Same-named params are unified across pipelines by object identity, so
setting a free param once steers every pipeline. The fitting layer drives
it eagerly (``get_outputs``) or through one compiled template per pipeline
(``analysis/gradient.py:CompiledDistribution``).

All pipelines live on one device, ``device="cuda"`` (the default) or
``device="cpu"``; pipelines handed in ready-made must live there too.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu_torch.core.container import resolve_device
from pisa_tpu_torch.core.map import MapSet
from pisa_tpu_torch.core.param import ParamSet
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.random_numbers import get_random_state

__all__ = ["DistributionMaker"]


class DistributionMaker:
    """
    Parameters
    ----------
    pipelines : Pipeline, config path/dict, or iterable thereof
    label : str, optional
    profile : bool
    shared_params : list of str, optional
        Accepted for the reference's signature; same-named params are
        shared in any case.
    device : torch.device or str
        Where the pipelines built here live; a ready-made Pipeline must
        live there.
    """

    def __init__(self, pipelines, label=None, profile=False,
                 shared_params=None, device="cuda"):
        self.label = label
        self.profile = profile
        self.device = resolve_device(device)
        if isinstance(pipelines, (str, dict, Pipeline)):
            pipelines = [pipelines]
        self._pipelines = []
        for p in pipelines:
            if not isinstance(p, Pipeline):
                p = Pipeline(p, device=self.device, profile=profile)
            elif p.device != self.device:
                raise ValueError(f"pipeline {p.name!r} lives on {p.device},"
                                 f" the DistributionMaker on {self.device}")
            self._pipelines.append(p)

        # unify same-named params across pipelines by object identity
        # (reference distribution_maker.py:189-203)
        shared = {}
        for pipeline in self._pipelines:
            for stage in pipeline.stages:
                for p in list(stage.params):
                    if p.name not in shared:
                        shared[p.name] = p
                        continue
                    existing = shared[p.name]
                    if existing is not p:
                        if existing != p:
                            logging.warning(
                                "Param %s differs between pipelines;"
                                " sharing the first definition", p.name,
                            )
                        stage._param_selector.update(
                            existing, existing_must_match=False
                        )

        selections = None
        for p in self._pipelines:
            if selections is not None and set(p.param_selections) != selections:
                logging.debug(
                    "Pipelines have differing param selections: %s vs %s",
                    selections, p.param_selections,
                )
            selections = set(p.param_selections)

    # -- access ---------------------------------------------------------------
    @property
    def pipelines(self):
        return self._pipelines

    def __iter__(self):
        return iter(self._pipelines)

    def __getitem__(self, i):
        return self._pipelines[i]

    def __len__(self):
        return len(self._pipelines)

    @property
    def params(self) -> ParamSet:
        params = ParamSet()
        for pipeline in self._pipelines:
            params.extend(pipeline.params)
        return params

    @property
    def param_selections(self):
        selections = set()
        for pipeline in self._pipelines:
            selections.update(pipeline.param_selections)
        return sorted(selections)

    def select_params(self, selections, error_on_missing=True):
        successes = 0
        for pipeline in self._pipelines:
            try:
                pipeline.select_params(selections, error_on_missing=True)
                successes += 1
            except KeyError:
                pass
        if error_on_missing and successes == 0:
            raise KeyError(f"No pipeline accepted selections {selections}")

    # -- evaluation -------------------------------------------------------------
    def get_outputs(self, return_sum=False, **kwargs):
        """Every pipeline's MapSet (a list of per-selection MapSets for a
        VarBinning output); with `return_sum`, all maps of all pipelines
        summed into a one-map MapSet, per selection for a VarBinning
        (reference ``distribution_maker.py:251``)."""
        outputs = [p.get_outputs(**kwargs) for p in self._pipelines]
        if not return_sum:
            return outputs
        if isinstance(outputs[0], list):
            # VarBinning: a list (one per selection) of MapSets
            summed = []
            for i in range(len(outputs[0])):
                total = None
                for out in outputs:
                    s = out[i].sum()
                    total = s if total is None else total + s
                summed.append(MapSet([total], name=self.label))
            return summed
        total = None
        for out in outputs:
            s = out.sum()
            total = s if total is None else total + s
        return MapSet([total], name=self.label)

    def update_params(self, params, existing_must_match=False):
        for pipeline in self._pipelines:
            pipeline.update_params(params, existing_must_match)

    def run(self):
        for p in self._pipelines:
            p.run()

    def setup(self):
        for p in self._pipelines:
            p.setup()

    # -- fitting interface --------------------------------------------------------
    def set_free_params(self, values):
        """Set the free params' values (Quantities, in free-param order)."""
        free = self.params.free
        if len(values) != len(free):
            raise ValueError(
                f"Got {len(values)} values for {len(free)} free params"
            )
        for p, v in zip(free, values):
            p.value = v

    def _set_rescaled_free_params(self, rvalues):
        """Set the free params from [0, 1]-rescaled values."""
        free = self.params.free
        if len(rvalues) != len(free):
            raise ValueError(
                f"Got {len(rvalues)} values for {len(free)} free params"
            )
        for p, v in zip(free, rvalues):
            p._rescaled_value = float(v)

    def randomize_free_params(self, random_state=None):
        self.params.randomize_free(get_random_state(random_state))

    def reset_all(self):
        self.params.reset_all()

    def reset_free(self):
        self.params.reset_free()

    def set_nominal_by_current_values(self):
        self.params.set_nominal_by_current_values()

    # -- diagnostics -----------------------------------------------------------
    def num_events_per_bin(self):
        """Unweighted event counts per output bin, per pipeline."""
        from pisa_tpu_torch.core import translation

        out = []
        for pipeline in self._pipelines:
            binning = pipeline.output_binning
            counts = np.zeros(binning.size)
            for container in pipeline.data.containers:
                container.representation = "events"
                sample = [container[n] for n in binning.names]
                counts += translation.histogram(
                    sample, None, binning).cpu().numpy()
            out.append(counts.reshape(binning.shape))
        return out

    def empty_bin_indices(self):
        return [np.argwhere(c == 0) for c in self.num_events_per_bin()]

    def report_profile(self, detailed=False):
        for p in self._pipelines:
            p.report_profile(detailed=detailed)

    def __str__(self):
        return f"DistributionMaker({[str(p) for p in self._pipelines]})"

    __repr__ = __str__
