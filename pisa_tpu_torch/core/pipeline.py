"""
Pipeline: an ordered chain of stages producing a binned template.

Counterpart of ``pisa_tpu/core/pipeline.py`` (reference
``pisa/core/pipeline.py:73``): built from a config (file path, parsed
OrderedDict, or dict), it instantiates its services by import path
``pisa_tpu_torch.stages.<stage>.<service>``, unifies same-named params
across stages into shared objects, and evaluates templates eagerly with
``get_outputs()``. It carries the surface the fitting layers call
(``core/distribution_maker.py``, ``analysis/analysis.py``): rescaled and
physical free-param setters, resets, ``update_params``, the output binning
and key, and per-stage timing with ``profile=True``.

The data lives on one explicit device: ``device="cuda"`` (the default) or
``device="cpu"``. A CUDA device without a card raises; nothing falls back to
the CPU. ``compile()`` gives the pipeline as one differentiable function of
its free parameters (:class:`pisa_tpu_torch.core.template.CompiledTemplate`).
A ``VarBinning`` output binning gives a list of per-selection MapSets, eagerly,
as in the JAX package.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.binning import OneDimBinning, VarBinning
from pisa_tpu_torch.core.container import ContainerSet, resolve_device
from pisa_tpu_torch.core.map import Map, MapSet
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
    profile : bool
        Record setup, run and get_outputs times, and each stage's
        (:meth:`report_profile`).
    """

    def __init__(self, config, device="cuda", profile=False):
        if isinstance(config, str):
            from pisa_tpu_torch.config.parser import parse_pipeline_config

            config = parse_pipeline_config(config)
        if not isinstance(config, dict):
            raise TypeError(f"Cannot interpret config of type {type(config)}")
        self.device = resolve_device(device)
        self._config = config
        pipeline_settings = config.get("pipeline", {})
        self.name = pipeline_settings.get("name", "pipeline")
        self.detector_name = pipeline_settings.get("detector_name")
        self._output_binning = pipeline_settings.get("output_binning")
        self._output_key = pipeline_settings.get("output_key")
        self.param_selections_applied = pipeline_settings.get(
            "param_selections", []
        )
        self.profile = profile
        self._get_outputs_times = []
        self._run_times = []
        self._setup_times = []

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
            settings = dict(settings)
            settings.setdefault("profile", self.profile)
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
        t0 = time.perf_counter()
        self.data = ContainerSet(self.name, device=self.device)
        if self._output_binning is not None:
            self.data["output_binning"] = self._output_binning
        for stage in self.stages:
            stage.data = self.data
            stage.param_hash = None
            stage.setup()
        self._setup_times.append(time.perf_counter() - t0)

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

    def update_params(self, params, existing_must_match=False, extend=False):
        """Put the params of `params` (ParamSet or sequence) into every
        stage that has one of their names, by object (so they are shared
        with whoever else holds them)."""
        params = params if isinstance(params, ParamSet) else ParamSet(params)
        for stage in self.stages:
            for p in params:
                if p.name in stage.params:
                    stage._param_selector.update(
                        p, existing_must_match=existing_must_match
                    )

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

    @output_binning.setter
    def output_binning(self, binning):
        self._output_binning = binning

    @property
    def output_key(self):
        return self._output_key

    @output_key.setter
    def output_key(self, key):
        self._output_key = key

    def run(self):
        t0 = time.perf_counter()
        for stage in self.stages:
            logging.trace("running %s", stage)
            stage.run()
        self._run_times.append(time.perf_counter() - t0)

    def get_outputs(self, output_binning=None, output_key=None,
                    return_sum=False):
        """Evaluate the template: run all stages and read the output keys in
        the output binning (reference ``pipeline.py:360-483``). Returns a
        host MapSet, or for a ``VarBinning`` a list of per-selection
        MapSets; with `return_sum`, the maps summed into a one-map MapSet
        (per selection), so that a lone Pipeline serves as a hypo maker."""
        if return_sum:
            out = self.get_outputs(output_binning, output_key)
            if isinstance(out, list):
                return [MapSet([ms.sum()], name=self.name) for ms in out]
            return MapSet([out.sum()], name=self.name)
        t0 = time.perf_counter()
        output_binning = output_binning or self._output_binning
        output_key = output_key or self._output_key
        if output_binning is None:
            raise ValueError("No output binning defined")
        self.run()
        if isinstance(output_key, (tuple, list)):
            key, error_key = output_key[0], output_key[1]
        else:
            key, error_key = output_key, None
        if isinstance(output_binning, VarBinning):
            outputs = self._get_outputs_varbinning(output_binning, key,
                                                   error_key)
        else:
            self.data.representation = output_binning
            outputs = self.data.get_mapset(key, error=error_key)
        self._get_outputs_times.append(time.perf_counter() - t0)
        return outputs

    def _get_outputs_varbinning(self, output_binning, key, error_key):
        """Per-selection MapSets: each selection's events (a bin of the
        split dimension, or a cut string) histogrammed under its own binning,
        with sumw2 errors where an error key is asked for (reference
        ``pipeline.py:389``; ``pisa_tpu/core/pipeline.py:262``)."""
        selections = output_binning.selections
        outputs = []
        for i, binning in enumerate(output_binning.binnings):
            maps = []
            for container in self.data.containers:
                container.representation = "events"
                if isinstance(selections, OneDimBinning):
                    var = container[selections.name]
                    edges = selections.edge_magnitudes
                    upper = (var < edges[i + 1]
                             if i < selections.num_bins - 1
                             else var <= edges[i + 1])
                    mask = (var >= edges[i]) & upper
                else:
                    mask = container.get_keep_mask(selections[i])
                sample = [container[n][mask] for n in binning.names]
                weights = container[key][mask]
                hist = translation.histogram(sample, weights, binning)
                err = None
                if error_key is not None:
                    err = torch.sqrt(translation.histogram(
                        sample, torch.square(weights), binning))
                maps.append(Map(
                    name=container.name,
                    hist=hist.detach().cpu().numpy().reshape(binning.shape),
                    binning=binning,
                    error_hist=None if err is None else
                    err.detach().cpu().numpy().reshape(binning.shape),
                ))
            outputs.append(MapSet(maps, name=f"{self.name}_sel{i}"))
        return outputs

    def compile(self, output_binning=None, output_key=None, **options):
        """The pipeline as a differentiable function of its rescaled free
        parameters; `options` are ``stack``, ``rate_defer``, ``hoist`` and
        ``capture`` of :class:`pisa_tpu_torch.core.template.
        CompiledTemplate` (by default the categories are stacked where
        every traced stage can run stacked, and on a CUDA device the
        template call is captured)."""
        from pisa_tpu_torch.core.template import CompiledTemplate

        return CompiledTemplate(
            self,
            output_binning=output_binning or self._output_binning,
            output_key=output_key or self._output_key,
            **options,
        )

    # -- fitting interface (the DistributionMaker surface, so that a lone
    # Pipeline serves as a hypo maker) -----------------------------------------
    def _set_rescaled_free_params(self, rvalues):
        free = self.params.free
        if len(rvalues) != len(free):
            raise ValueError(
                f"Got {len(rvalues)} values for {len(free)} free params"
            )
        for p, v in zip(free, rvalues):
            p._rescaled_value = float(v)

    def set_free_params(self, values):
        free = self.params.free
        if len(values) != len(free):
            raise ValueError(
                f"Got {len(values)} values for {len(free)} free params"
            )
        for p, v in zip(free, values):
            p.value = v

    def reset_free(self):
        self.params.reset_free()

    def reset_all(self):
        self.params.reset_all()

    # -- profiling ----------------------------------------------------------------
    @staticmethod
    def _format_times(times):
        """'n=..., total=..., mean +- std, min/max' of a list of times
        (reference ``format.format_times``)."""
        t = np.asarray(times, dtype=np.float64)
        if t.size == 0:
            return "n=0"
        return (
            f"n={t.size}, total={t.sum():.4f} s,"
            f" mean={t.mean() * 1e3:.2f} +- {t.std() * 1e3:.2f} ms,"
            f" min={t.min() * 1e3:.2f} ms, max={t.max() * 1e3:.2f} ms"
        )

    def report_profile(self, detailed=False):
        """The pipeline's setup, run and get_outputs times and, with
        `detailed`, each stage's setup, compute and apply times (reference
        ``pipeline.py:148-187``); host times, recorded with
        ``profile=True``."""
        print(f"Pipeline: {self.name}")
        for label, times in (("setup", self._setup_times),
                             ("run", self._run_times),
                             ("get_outputs", self._get_outputs_times)):
            if times:
                print(f"  {label + ':':12s} {self._format_times(times)}")
        if detailed:
            for stage in self.stages:
                print(f"  {stage}:")
                for label, times in (("setup", stage.setup_times),
                                     ("compute", stage.calc_times),
                                     ("apply", stage.apply_times)):
                    if times:
                        print(f"    {label}: {self._format_times(times)}")

    def _stage_table_rows(self):
        """(headers, rows) describing each stage (reference
        ``pipeline.py:138-146``)."""
        headers = ["stage number", "name", "calc_mode", "apply_mode",
                   "# fixed params", "# free params"]
        rows = [
            [str(i), f"{s.stage_name}.{s.service_name}", str(s.calc_mode),
             str(s.apply_mode), str(len(s.params.fixed)),
             str(len(s.params.free))]
            for i, s in enumerate(self.stages)
        ]
        return headers, rows

    def tabulate(self, tablefmt="plain"):
        """Plain ('plain'/'presto') or 'html' table of the pipeline's stages
        (reference ``pipeline.py:138``)."""
        headers, rows = self._stage_table_rows()
        if tablefmt == "html":
            cells = "".join(f"<th>{h}</th>" for h in headers)
            body = "".join(
                "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
                for row in rows
            )
            return (f"<table><thead><tr>{cells}</tr></thead>"
                    f"<tbody>{body}</tbody></table>")
        widths = [max(len(h), *(len(r[j]) for r in rows)) if rows else len(h)
                  for j, h in enumerate(headers)]
        sep = " | " if tablefmt == "presto" else "  "
        lines = [sep.join(h.ljust(w) for h, w in zip(headers, widths))]
        if tablefmt == "presto":
            lines.append("-+-".join("-" * w for w in widths))
        for row in rows:
            lines.append(sep.join(c.ljust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    def _repr_html_(self):
        return self.tabulate(tablefmt="html")

    def __str__(self):
        stages = " -> ".join(str(s) for s in self.stages)
        return f"Pipeline('{self.name}': {stages})"

    __repr__ = __str__
