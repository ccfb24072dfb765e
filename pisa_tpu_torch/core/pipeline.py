"""
Pipeline: an ordered chain of stages producing a binned template.

Counterpart of ``pisa_tpu/core/pipeline.py`` (reference
``pisa/core/pipeline.py:73``): built from a config (file path, parsed
OrderedDict, or dict), it instantiates its services by import path
``pisa_tpu_torch.stages.<stage>.<service>``, unifies same-named params
across stages into shared objects, and evaluates templates eagerly with
``get_outputs()``.

The data lives on one explicit device: ``device="cuda"`` (the default) or
``device="cpu"``. A CUDA device without a card raises; nothing falls back to
the CPU. ``compile()`` gives the pipeline as one differentiable function of
its free parameters (:class:`pisa_tpu_torch.core.template.CompiledTemplate`).
Per-selection ``VarBinning`` outputs are not ported yet.
"""

from __future__ import annotations

import importlib

from pisa_tpu_torch.core.binning import VarBinning
from pisa_tpu_torch.core.container import ContainerSet, resolve_device
from pisa_tpu_torch.core.param import ParamSet
from pisa_tpu_torch.utils.log import logging

__all__ = ["Pipeline"]


class Pipeline:
    """
    Parameters
    ----------
    config : str (cfg file path), OrderedDict from parse_pipeline_config, or
        dict with keys 'pipeline' and stage tuples
    device : torch.device or str
        Where the containers' tensors live and the kernels run.
    """

    def __init__(self, config, device="cuda"):
        if isinstance(config, str):
            from pisa_tpu_torch.config.parser import parse_pipeline_config

            config = parse_pipeline_config(config)
        if not isinstance(config, dict):
            raise TypeError(f"Cannot interpret config of type {type(config)}")
        self.device = resolve_device(device)
        self._config = config
        pipeline_settings = config.get("pipeline", {})
        self.name = pipeline_settings.get("name", "pipeline")
        self._output_binning = pipeline_settings.get("output_binning")
        self._output_key = pipeline_settings.get("output_key")
        self.param_selections_applied = pipeline_settings.get(
            "param_selections", []
        )

        self.data = ContainerSet(self.name, device=self.device)
        self.stages = []
        self._init_stages()
        self.setup()

    # -- construction ----------------------------------------------------------
    def _init_stages(self):
        """Instantiate stage services and unify shared params (reference
        ``pipeline.py:249-358``)."""
        shared_params = ParamSet()
        all_selections = set(
            s.strip().lower() for s in self.param_selections_applied if s
        )
        for key, settings in self._config.items():
            if not isinstance(key, tuple):
                continue
            stage_name, service_name = key
            cls = self._import_service(stage_name, service_name)
            stage = cls(**settings)
            stage.data = self.data
            self.stages.append(stage)

            # same-named params across stages must be the same object, so
            # one fit param steers all uses
            for p in list(stage.params):
                if p.name in shared_params:
                    existing = shared_params[p.name]
                    if existing != p:
                        raise ValueError(
                            f"Stage {stage}: param {p.name!r} conflicts with"
                            " the same-named param of an earlier stage"
                        )
                    stage._param_selector.update(
                        existing, existing_must_match=True
                    )
                else:
                    shared_params.extend(p)
            all_selections.update(stage.param_selections)

        if all_selections:
            self.select_params(sorted(all_selections))

    @staticmethod
    def _import_service(stage_name, service_name):
        # pi_* legacy names map to bare names (reference pipeline.py:273)
        if service_name.startswith("pi_"):
            service_name = service_name[3:]
        module_path = f"pisa_tpu_torch.stages.{stage_name}.{service_name}"
        module = importlib.import_module(module_path)
        return getattr(module, service_name)

    def setup(self):
        """Fresh ContainerSet shared by every stage; run every stage's setup
        (reference ``pipeline.py:560-577``)."""
        self.data = ContainerSet(self.name, device=self.device)
        if self._output_binning is not None:
            self.data["output_binning"] = self._output_binning
        for stage in self.stages:
            stage.data = self.data
            stage.param_hash = None
            stage.setup()

    # -- params -----------------------------------------------------------------
    @property
    def params(self) -> ParamSet:
        params = ParamSet()
        for stage in self.stages:
            params.extend(stage.params)
        return params

    @property
    def param_selections(self):
        selections = set()
        for stage in self.stages:
            selections.update(stage.param_selections)
        return sorted(selections)

    def select_params(self, selections, error_on_missing=False):
        successes = 0
        for stage in self.stages:
            try:
                stage.select_params(selections, error_on_missing=True)
                successes += 1
            except KeyError:
                pass
        if error_on_missing and successes == 0:
            raise KeyError(f"No stage accepted param selections {selections}")

    def index(self, stage_id):
        """Index of a stage by int, 'stage_name', or 'stage_name.service'."""
        if isinstance(stage_id, int):
            return stage_id
        for i, s in enumerate(self.stages):
            if stage_id in (s.stage_name, f"{s.stage_name}.{s.service_name}"):
                return i
        raise ValueError(f"No stage {stage_id!r} in {self}")

    def __getitem__(self, stage_id):
        return self.stages[self.index(stage_id)]

    def __iter__(self):
        return iter(self.stages)

    def __len__(self):
        return len(self.stages)

    # -- evaluation --------------------------------------------------------------
    @property
    def output_binning(self):
        return self._output_binning

    @property
    def output_key(self):
        return self._output_key

    def run(self):
        for stage in self.stages:
            logging.trace("running %s", stage)
            stage.run()

    def get_outputs(self, output_binning=None, output_key=None):
        """Evaluate the template: run all stages and read the output keys in
        the output binning (reference ``pipeline.py:360-483``). Returns a
        host MapSet."""
        output_binning = output_binning or self._output_binning
        output_key = output_key or self._output_key
        if output_binning is None:
            raise ValueError("No output binning defined")
        if isinstance(output_binning, VarBinning):
            raise NotImplementedError(
                "VarBinning outputs are ported with ROADMAP queue 1 item 11"
            )
        self.run()
        if isinstance(output_key, (tuple, list)):
            key, error_key = output_key[0], output_key[1]
        else:
            key, error_key = output_key, None
        self.data.representation = output_binning
        return self.data.get_mapset(key, error=error_key)

    def compile(self, output_binning=None, output_key=None, **options):
        """The pipeline as a differentiable function of its rescaled free
        parameters; `options` are ``stack``, ``rate_defer`` and ``hoist``
        of :class:`pisa_tpu_torch.core.template.CompiledTemplate` (by
        default the categories are stacked where every traced stage can
        run stacked)."""
        from pisa_tpu_torch.core.template import CompiledTemplate

        return CompiledTemplate(
            self,
            output_binning=output_binning or self._output_binning,
            output_key=output_key or self._output_key,
            **options,
        )

    def __str__(self):
        stages = " -> ".join(str(s) for s in self.stages)
        return f"Pipeline('{self.name}': {stages})"

    __repr__ = __str__
