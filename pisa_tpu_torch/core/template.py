"""
A pipeline as one differentiable function of its free parameters.

Counterpart of ``pisa_tpu/core/template.py``: ``Pipeline.compile()``
returns a :class:`CompiledTemplate`, a function

    rescaled free params (vector in [0, 1]^n) -> {category: flat binned hist}

whose gradient (and the fit metric's) comes from autograd, with the
oscillation stage's gradient running the CUDA tangent kernels
(``ops/osc/chain.py:osc_probs``). It replaces the reference's
finite-difference gradients (~2n templates per step, ``analysis.py:1561``).

Mechanics, as in the JAX package:

- the free params' magnitudes are set on the shared Param objects as 0-d
  float64 tensors **on the pipeline's device** that carry the autograd graph
  (wrapped in unit-tagged Quantities, so stage code is unchanged): from the
  rescaled vector to the value and the gradient nothing is computed on the
  host and nothing waits for the card;
- the stages' compute caches are bypassed (template mode); the leading
  stages with no free parameter run once here (``hoist``), and every
  evaluation starts from the container state they left, then restores the
  state it found, so the eager ``get_outputs()`` path is unaffected;
- the categories are stacked into one container (``core/stacking.py``,
  ``stack``) when every traced stage can run on it; otherwise the template
  runs per container and says so (:attr:`CompiledTemplate.stacked`);
- the oscillation stage's grid rate may be handed to the histogram stage
  (``rate_defer``, :meth:`CompiledTemplate._setup_rate_deferral`), which is
  reported too (:attr:`CompiledTemplate.rate_deferred`). The state of that
  hand-off lives on this template's own stacked container, so two templates
  over one pipeline do not interfere.

Where the JAX package has ``jax.jit``, the port captures CUDA graphs on a
CUDA device: the template call itself (``vec, los, his -> histograms``,
:class:`CapturedFunction`, at the first call), and in
:meth:`build_objective` the whole ``value_and_grad`` (magnitudes, pack,
stages, metric, priors and the backward with its kernel launches) and the
value alone (:class:`CapturedObjective`); an evaluation copies its inputs
into the graphs' static tensors and replays. A graph bakes in what it read
at capture: the fixed params' values and the container data (by address).
On the CPU the same code runs eagerly.

:meth:`CompiledTemplate.shard` splits the template over the ranks of a mesh
(``parallel/sharding.py``): each rank then holds its slice of the events,
the histogram stage sums the ranks' partial histograms with one
``all_reduce``, and every rank holds the whole template, value and
gradient. On NCCL the collectives are captured with the rest of a
``value_and_grad``.

Lanes (the batched fits, the counterpart of ``jax.vmap`` over the template):
a (B, n) rescaled matrix evaluates B independent parameter points in one
program. Each free magnitude is then a (B, 1) tensor, so per-event
arithmetic broadcasts to (B, E); the containers see ``lanes`` = B
(``core/container.py``), and every output gains a leading lane axis. The
oscillation kernels launch as often as for one point, each launch serving
all lanes (``ops/osc/chain.py``). A :class:`CapturedObjective` captures a
batched objective as it does a single one, one program per B.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core import stacking
from pisa_tpu_torch.core.map import Map, MapSet
from pisa_tpu_torch.units import Quantity
from pisa_tpu_torch.utils.daemonflux_native import compiled_daemon_penalty
from pisa_tpu_torch.utils.log import logging

__all__ = ["CompiledTemplate", "CapturedObjective", "CapturedFunction",
           "magnitudes_from_rescaled", "wrap_objective", "HOST_PARAM_NAMES",
           "RATE_DEFER_DEFAULT", "CAPTURE_WARMUP", "LLH_KEYS"]

#: params that steer host-side precomputation and hence cannot be
#: differentiated (``pisa_tpu/core/template.py:42-56``); stages add theirs
#: through ``host_param_names``
HOST_PARAM_NAMES = {
    "earth_model",
    "detector_depth",
    "prop_height",
    "YeI",
    "YeO",
    "YeM",
    "density_scale",
    "core_density_scale",
    "innermantle_density_scale",
    "middlemantle_density_scale",
    "n_events",
    "seed",
    "random",
}

#: Whether ``Pipeline.compile()`` sets up rate deferral where the stages
#: allow it: the route with the lower captured ``value_and_grad`` at the
#: flagship on one H100 (``PERF.md`` has the measurement). Both routes give
#: the same values.
RATE_DEFER_DEFAULT = True

#: eager evaluations on a side stream before a capture (they build every
#: lazily cached tensor outside the graph's memory pool, and let the kernels
#: opt into their shared memory)
CAPTURE_WARMUP = 3

#: the generalized likelihood's inputs, which a template returns beside the
#: histograms where its pipeline makes them
#: (``likelihood.generalized_llh_params``; ``pisa_tpu/core/template.py:448``)
LLH_KEYS = ("llh_alphas", "llh_betas", "n_mc_events")


def magnitudes_from_rescaled(vec, los, his, log_scaled):
    """Physical magnitudes (a list of 0-d tensors, differentiable in `vec`)
    of the rescaled vector `vec` between the bounds `los` and `his`, with
    the params flagged in `log_scaled` scaling as logs
    (``Param._rescaled_value``; ``pisa_tpu/core/template.py:364``). For a
    (B, n) matrix of lanes each magnitude is a (B, 1) tensor, which
    broadcasts over the events."""
    mags = list((los + (his - los) * vec).unbind(-1))
    for i, log_scale in enumerate(log_scaled):
        if log_scale:
            lo, hi = los[i], his[i]
            mags[i] = torch.exp(
                vec[..., i] * (torch.log(hi.abs()) - torch.log(lo.abs()))
            ) * lo
    if vec.dim() == 2:
        mags = [m[:, None] for m in mags]
    return mags


class CompiledTemplate:
    """``rescaled free params -> histograms`` for a Pipeline.

    Parameters
    ----------
    pipeline : Pipeline
    output_binning : MultiDimBinning
    output_key : str or (key, error_key)
    stack : bool
        Stack the categories into one container where every traced stage
        can run on it (``PISA_TPU_STACK`` in the JAX package).
    rate_defer : bool
        On a stacked template, hand the oscillation stage's grid rate to
        the histogram stage where the stage lineup allows it
        (``PISA_TPU_RATE_DEFER``).
    hoist : bool
        Run the leading stages without free parameters once, here
        (``PISA_TPU_HOIST``).
    capture : bool or None
        Capture the template call in a CUDA graph at its first call (by
        default: on a CUDA device); ``False`` keeps the eager route.

    The vector is in the *rescaled* [0, 1] space of minimizers (reference
    ``param.py:358``); the conversion to physical magnitudes happens inside,
    so gradients are with respect to the rescaled values.
    """

    def __init__(self, pipeline, output_binning, output_key, stack=True,
                 rate_defer=RATE_DEFER_DEFAULT, hoist=True, capture=None):
        self.pipeline = pipeline
        device = pipeline.device
        if capture is None:
            capture = device.type == "cuda"
        elif capture and device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device, not {device}")
        self.capture = bool(capture)
        #: the captured template call (:class:`CapturedFunction`), made at
        #: the first call on a capturing template
        self._program = None
        self.output_binning = output_binning
        if isinstance(output_key, (tuple, list)):
            self.output_key, self.error_key = output_key[0], output_key[1]
        else:
            self.output_key, self.error_key = output_key, None

        host_params = set(HOST_PARAM_NAMES)
        for stage in pipeline.stages:
            host_params.update(stage.host_param_names)
        free = pipeline.params.free
        for p in free:
            if p.name in host_params:
                raise ValueError(
                    f"Free param {p.name!r} steers host-side precomputation"
                    " and cannot be part of a compiled template; fix it or"
                    " use the eager path"
                )
        self.free_names = list(free.names)
        self._free_params = list(free)
        self._log_scaled = [p.scales_as_log for p in self._free_params]
        self.names = list(pipeline.data.names)

        # The leading stages with no free parameter run once, here; every
        # evaluation starts from the container state they leave.
        self._hoisted_stages, self._traced_stages = self._split_stages(hoist)
        for stage in self._hoisted_stages:
            stage.run()

        #: the pipeline's containers as the hoisted stages left them (a
        #: sharded template's copies are cut from this state)
        self._hoisted_state = pipeline.data.state()
        #: the ContainerSet the traced stages run on: the pipeline's own, or
        #: its stacked copy (or, sharded, this rank's slices of either)
        self._trace_data = pipeline.data
        if stack:
            self._build_stacked(rate_defer)
        self._base_state = self._trace_data.state()
        self._bounds_cache = None
        #: the mesh the template is sharded over (:meth:`shard`), or None
        self.mesh = None
        #: advanced by :meth:`shard`; objectives built before it refuse to
        #: run (:func:`wrap_objective`)
        self._generation = 0

    # -- what the template runs on --------------------------------------------
    @property
    def device(self):
        return self.pipeline.device

    @property
    def stacked(self):
        """Whether the traced stages run on one category-stacked
        container."""
        return any(getattr(c, "is_stacked", False)
                   for c in self._trace_data.containers)

    @property
    def rate_deferred(self):
        """Whether the oscillation stage hands its grid rate to the
        histogram stage (only on a stacked template)."""
        return self.stacked and all(
            c.rate_defer is not None for c in self._trace_data.containers
        )

    def _split_stages(self, hoist=True):
        """(hoisted, traced): the longest leading run of stages none of
        whose params is free, directly or through a DerivedParam dependency
        (``pisa_tpu/core/template.py:140``). Only a prefix is safe: a stage
        without free params downstream of a traced one (e.g. utils.hist)
        consumes per-template values."""
        stages = list(self.pipeline.stages)
        if not hoist:
            return [], stages

        def expand(p):
            yield p
            for dep in getattr(p, "dependson", {}).values():
                yield from expand(dep)

        free_ids = {id(p) for p in self._free_params}
        n_hoisted = 0
        for stage in stages:
            if any(id(q) in free_ids for p in stage.params for q in expand(p)):
                break
            n_hoisted += 1
        return stages[:n_hoisted], stages[n_hoisted:]

    def _coord_keys(self):
        """Event keys that are binning coordinates (NaN-padded when
        stacking): any dimension of any binning the template touches."""
        coord_keys = set(self.output_binning.names)
        for stage in self.pipeline.stages:
            for mode in (stage.calc_mode, stage.apply_mode):
                if hasattr(mode, "names"):
                    coord_keys.update(mode.names)
        return coord_keys

    def _build_stacked(self, rate_defer, pad_multiple=1):
        """Stack the pipeline's containers for the traced stages where they
        all can run stacked, the event axis padded to a multiple of
        `pad_multiple`; otherwise ``self._trace_data`` stays the pipeline's
        own set, and the reason is logged."""
        if len(self.pipeline.data.containers) < 2:
            logging.info("stacking off: fewer than 2 containers")
            return
        unsupported = [str(s) for s in self._traced_stages
                       if not s.stacked_ok()]
        if unsupported:
            logging.warning("stacking off: stages that cannot run stacked:"
                            " %s", unsupported)
            return
        exclude = set()
        for s in self._traced_stages:
            exclude.update(s.stacking_exclude_keys())
        try:
            self._trace_data = stacking.build_stacked_set(
                self.pipeline.data, coord_keys=self._coord_keys(),
                exclude_keys=exclude, pad_multiple=pad_multiple,
            )
        except stacking.StackingError as exc:
            logging.warning("stacking off: %s", exc)
            return
        for stage in self._traced_stages:
            stage.prepare_stacked(self._trace_data)
        logging.debug(
            "stacked %d containers (n_pad=%d)",
            len(self.pipeline.data.containers),
            self._trace_data.containers[0].n_pad,
        )
        if rate_defer:
            self._setup_rate_deferral()

    def _setup_rate_deferral(self):
        """Set up the factorized histogram where the stage lineup allows
        it: one grid-calc oscillation stage, one events -> binned histogram
        stage after it, and every other traced stage keeping the
        category-scalar weight contract (``stacked_rate_defer_ok``,
        core/stage.py). The oscillation stage then hands its (6, ngrid)
        flux x probability rate to the histogram stage
        (``prob3._apply_stacked``), which contracts it with static (grid x
        bins) matrices (``hist.prepare_rate_defer``) in place of the grid ->
        events gather and its reverse-pass scatter. The matrices and the
        hand-off live on this template's stacked container
        (``container.rate_defer``, ``container.deferred_rate``)."""
        from pisa_tpu_torch.stages.osc.prob3 import prob3
        from pisa_tpu_torch.stages.utils.hist import hist

        stages = self._traced_stages
        oscs = [s for s in stages if isinstance(s, prob3)]
        hists = [s for s in stages if isinstance(s, hist)]
        if len(oscs) != 1 or len(hists) != 1:
            return
        osc, hs = oscs[0], hists[0]
        if not osc.is_map or stages.index(hs) < stages.index(osc):
            return
        others = [s for s in stages if s is not osc and s is not hs]
        if not all(s.stacked_rate_defer_ok() for s in others):
            return
        if any(s.stage_name == "flux" and not s.is_map
               for s in self.pipeline.stages):
            # a per-event flux (daemon_flux): the oscillation stage forms
            # the rate per event and hands none over (prob3._apply_stacked),
            # so the matrices would go unused. The JAX package builds them
            # all the same; the results are the same.
            logging.info("rate deferral off: the flux is per event")
            return
        static_keys = [k for s in others for k in s.stacked_static_weight_keys]
        if hs.prepare_rate_defer(self._trace_data, osc.calc_mode, static_keys):
            logging.info("rate deferral on: factorized histogram (static"
                         " keys %s)", static_keys)

    # -- sharding ------------------------------------------------------------------
    def shard(self, mesh, axis_name="data", shard_grid=None,
              grid_min=None):
        """Split the template over the ranks of `mesh`
        (``parallel/sharding.py``; ``pisa_tpu/core/template.py:482-550``);
        every rank of the mesh calls it, with a pipeline on the mesh's
        device. Returns self.

        A stacked template is stacked again with its event axis padded to a
        multiple of the mesh size where it is not one already
        (``build_stacked_set(pad_multiple=...)``, which runs the stages'
        ``prepare_stacked`` again); each rank then keeps its slice of the
        events and, under rate deferral, of a calc grid of at least
        `grid_min` points (``parallel.sharding.GRID_MIN`` by default) that
        divides by the mesh size, with `shard_grid` (by default on, unless
        ``PISA_TPU_SHARD_GRID`` is 0, off or false). A template that runs
        per container keeps each container's slice of the events. The
        histogram stage sums the ranks' partial histograms with one
        ``all_reduce``, and an objective built after this carries the
        gradient rule of ``parallel/sharding.py``: value and gradient are
        the whole template's on every rank.

        The pipeline's own containers are not changed: the slices are cut
        from the template's own copies of the state the hoisted stages left,
        padding included, so the pipeline's eager ``get_outputs()`` gives
        what it gave before. The captured template call is dropped, and
        objectives built before this raise when called (build them again).
        A sharded template over gloo, whose collectives cannot be captured,
        must have been compiled with ``capture=False``. Every traced stage
        must support sharding (``Stage.supports_shard``)."""
        from pisa_tpu_torch.parallel import sharding

        if self.mesh is not None:
            raise ValueError("the template is sharded already")
        if mesh.rank is None:
            raise ValueError("this rank is not in the mesh")
        if mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the"
                             f" pipeline's {self.device}")
        if self.capture and mesh.backend != "nccl":
            raise ValueError(
                f"{mesh.backend} collectives cannot be captured in a CUDA"
                " graph: compile the template with capture=False")
        unsupported = [str(s) for s in self._traced_stages
                       if not s.supports_shard]
        if unsupported:
            raise ValueError(f"stages that cannot run sharded: {unsupported}")
        if shard_grid is None:
            import os

            shard_grid = os.environ.get("PISA_TPU_SHARD_GRID", "1").lower() \
                not in ("0", "off", "false")
        n = mesh.size
        data = self.pipeline.data
        current = data.state()
        data.set_state(self._hoisted_state)
        try:
            if self.stacked:
                if self._trace_data.containers[0].n_pad % n:
                    logging.debug("shard(): stacking again with"
                                  " pad_multiple=%d", n)
                    rate_defer = self.rate_deferred
                    self._trace_data = data
                    self._build_stacked(rate_defer, pad_multiple=n)
                    if not self.stacked:
                        raise RuntimeError("shard(): stacking again with"
                                           f" pad_multiple={n} failed")
                sharding.shard_stacked_containers(
                    self._trace_data, mesh, axis_name=axis_name,
                    shard_grid=shard_grid,
                    grid_min=sharding.GRID_MIN if grid_min is None
                    else grid_min)
                # the one-hot matrices, fields and geometries of the slice
                for stage in self._traced_stages:
                    stage.prepare_stacked(self._trace_data)
            else:
                self._trace_data = sharding.shard_containers(
                    data, mesh, axis_name=axis_name,
                    coord_keys=self._coord_keys())
        finally:
            data.set_state(current)
        self._base_state = self._trace_data.state()
        self.mesh = mesh
        self._program = None
        self._generation += 1
        return self

    # -- parameters ------------------------------------------------------------
    def _current_bounds(self):
        """The free params' live range bounds (magnitudes in their units):
        runtime inputs, so range changes need no new template."""
        los = [float(p.range[0].m_as(p.units)) for p in self._free_params]
        his = [float(p.range[1].m_as(p.units)) for p in self._free_params]
        return np.asarray(los), np.asarray(his)

    def _device_bounds(self):
        """:meth:`_current_bounds` as tensors on the pipeline's device,
        uploaded again only when a range has changed."""
        los, his = self._current_bounds()
        cached = self._bounds_cache
        if cached is None or not (np.array_equal(los, cached[0])
                                  and np.array_equal(his, cached[1])):
            cached = self._bounds_cache = (
                los, his, self._on_device(los), self._on_device(his))
        return cached[2:]

    def _on_device(self, x):
        """`x` (array or tensor) as a float64 tensor on the pipeline's
        device; a tensor that lies elsewhere is refused, not moved."""
        device = self.pipeline.device
        if isinstance(x, torch.Tensor):
            if x.device != device:
                raise ValueError(f"the template lives on {device}; got a"
                                 f" tensor on {x.device}")
            return x.to(torch.float64)
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)

    def _magnitudes_from_rescaled(self, vec, los=None, his=None):
        """Physical magnitudes (0-d float64 tensors on the pipeline's
        device, differentiable in `vec`) of the rescaled vector, log-aware
        as ``Param._rescaled_value`` (``pisa_tpu/core/template.py:364``).
        Tensor arguments must lie on that device; arrays are uploaded."""
        if los is None or his is None:
            los, his = self._device_bounds()
        vec, los, his = (self._on_device(x) for x in (vec, los, his))
        return magnitudes_from_rescaled(vec, los, his, self._log_scaled)

    def current_rescaled_values(self):
        return np.asarray(
            [float(p._rescaled_value) for p in self._free_params],
            dtype=np.float64,
        )

    # -- evaluation ---------------------------------------------------------------
    def _evaluate(self, mags, lanes=None):
        """Run the traced stages with the free params at `mags` from the
        hoisted state; returns ``{"hist": {name: flat tensor}}`` (and
        ``"error"``, and each of :data:`LLH_KEYS` the containers hold) on
        the pipeline's device, with the autograd graph back to `mags`; on a
        stacked template also ``"hist_stacked"``, the (C, size) tensor the
        per-name entries are rows of (in the order of ``self.names``). With
        `lanes` = B (magnitudes of shape (B, 1)) every output has a leading
        lane axis: (B, size) per name, (B, C, size) stacked."""
        pipeline = self.pipeline
        data = self._trace_data
        saved_state = data.state()
        saved_values = [p._value for p in self._free_params]
        lead = () if lanes is None else (lanes,)
        for stage in pipeline.stages:
            stage._template_mode = True
        for stage in self._traced_stages:
            stage.data = data
        try:
            data.set_state(self._base_state)
            data.lanes = lanes
            for p, mag in zip(self._free_params, mags):
                p._value = Quantity(mag, p.units)
            for stage in self._traced_stages:
                stage.run()
            data.representation = self.output_binning
            out = {}
            keys = [("hist", self.output_key)]
            if self.error_key is not None:
                keys.append(("error", self.error_key))
            for label, key in keys:
                out[label] = {}
                for c in data.containers:
                    if getattr(c, "is_stacked", False):
                        # unstack: one flat (size,) view per category
                        values = c.expanded(key)
                        if c.rows[(key, hash(self.output_binning))] is None:
                            values = values.unsqueeze(len(lead)).expand(
                                lead + (c.n_cats,)
                                + tuple(values.shape[len(lead):]))
                        values = values.reshape(lead + (c.n_cats, -1))
                        out[label + "_stacked"] = values
                        out[label].update(zip(c.cat_names,
                                              values.unbind(len(lead))))
                    else:
                        out[label][c.name] = c[key].reshape(lead + (-1,))
            for key in LLH_KEYS:
                for c in data.containers:
                    if key in c.keys:
                        out.setdefault(key, {})[c.name] = c[key].reshape(
                            lead + (-1,))
            return out
        finally:
            data.lanes = None
            for p, value in zip(self._free_params, saved_values):
                p._value = value
            for stage in pipeline.stages:
                stage._template_mode = False
            for stage in self._traced_stages:
                stage.data = pipeline.data
            data.set_state(saved_state)

    def _stack_outputs(self, out):
        """(hist, error or None, total): the categories' histograms as one
        (C, size) tensor in the order of ``self.names``; lanes: (B, C, size)
        and (B,) totals."""
        stacks = []
        for label in ("hist", "error"):
            if label not in out:
                stacks.append(None)
            elif label + "_stacked" in out:
                stacks.append(out[label + "_stacked"])
            else:
                stacks.append(torch.stack([out[label][n] for n in self.names],
                                          dim=-2))
        hist = stacks[0]
        total = hist.sum() if hist.dim() == 2 else hist.sum(dim=(-2, -1))
        return hist, stacks[1], total

    def _stack_llh_inputs(self, out):
        """The :data:`LLH_KEYS` outputs as one (3, C, size) tensor in the
        order of ``self.names``, or None where the pipeline makes none."""
        if LLH_KEYS[0] not in out:
            return None
        return torch.stack([torch.stack([out[k][n] for n in self.names])
                            for k in LLH_KEYS])

    def _captured(self):
        """The captured template call, captured at the current values and
        bounds on first use (the warm-up runs and the capture launch the
        kernels; a replay does not advance their counters): (hist, error or
        None, total, the :data:`LLH_KEYS` stack or None)."""
        if self._program is None:
            def run(vec, los, his):
                out = self._evaluate(
                    self._magnitudes_from_rescaled(vec, los, his))
                return self._stack_outputs(out) + (
                    self._stack_llh_inputs(out),)

            self._program = CapturedFunction(
                run, self.current_rescaled_values(), *self._device_bounds(),
                device=self.pipeline.device)
        return self._program

    def __call__(self, rescaled_vector):
        """Raw evaluation: dict with 'hist' (and 'error', and the
        :data:`LLH_KEYS` where the pipeline makes them) name -> flat tensor
        on the pipeline's device; on a capturing template a replay of the
        captured call (copies of its outputs, with no autograd graph:
        gradients come from :meth:`build_objective`)."""
        if not self.capture:
            return self._evaluate(
                self._magnitudes_from_rescaled(rescaled_vector))
        hist, err, _, llh_inputs = self._captured()(rescaled_vector,
                                                    *self._device_bounds())
        out = {}
        for label, stacked in zip(("hist", "error"), (hist, err)):
            if stacked is not None:
                out[label] = dict(zip(self.names, stacked.clone().unbind()))
        if llh_inputs is not None:
            for key, stacked in zip(LLH_KEYS, llh_inputs.clone().unbind()):
                out[key] = dict(zip(self.names, stacked.unbind()))
        return out

    def scan_totals(self, vecs):
        """The summed template's total for each row of `vecs` (n, n_free),
        evaluated back to back with no wait for the card in between
        (``pisa_tpu/core/template.py:566``): an (n,) tensor on the
        pipeline's device. On a capturing template: one upload of `vecs`
        (through pinned memory, without a wait), then n replays, each
        followed by an enqueued copy of its total; the caller's read of the
        result is the one wait."""
        if not self.capture:
            vecs = self._on_device(vecs)
            los, his = self._device_bounds()
            with torch.no_grad():
                return torch.stack([
                    self._stack_outputs(self._evaluate(
                        self._magnitudes_from_rescaled(vec, los, his)))[2]
                    for vec in vecs])
        program = self._captured()
        los, his = self._device_bounds()
        vecs = program.upload(vecs)
        totals = torch.empty(vecs.shape[0], dtype=TORCH_FTYPE,
                             device=vecs.device)
        for i in range(vecs.shape[0]):
            total = program(vecs[i], los, his)[2]
            totals[i].copy_(total)
        return totals

    def get_outputs(self, rescaled_vector=None) -> MapSet:
        """Host-side MapSet in the pipeline's container order (mirrors
        ``Pipeline.get_outputs``); the current values by default. The
        histograms come to the host in one copy."""
        if rescaled_vector is None:
            rescaled_vector = self.current_rescaled_values()
        if self.capture:
            hist, err = self._captured()(rescaled_vector,
                                         *self._device_bounds())[:2]
        else:
            with torch.no_grad():
                hist, err, _ = self._stack_outputs(self(rescaled_vector))
        host = (hist if err is None else torch.stack([hist, err])).cpu()
        host = host.numpy()
        hist, err = (host, None) if err is None else host
        return MapSet([
            Map(name=name, hist=hist[i], binning=self.output_binning,
                error_hist=None if err is None else err[i])
            for i, name in enumerate(self.names)
        ], name=self.pipeline.name)

    # -- objectives ---------------------------------------------------------------
    def build_objective(self, data_dist, metric, priors=True, sum_maps=False,
                        capture=None):
        """Functions ``value_only(vec)`` and ``value_and_grad(vec) ->
        (value, grad)`` of the rescaled vector for fitting `data_dist`
        (MapSet, Map, or dict name -> array) under `metric`
        (``pisa_tpu/core/template.py:630-751``); value and gradient are
        tensors on the pipeline's device.

        As in the reference's minimizer convention (``analysis.py:2493``):
        the metric summed over maps plus the prior penalties, sign-flipped
        for llh-family metrics so that it is always minimized. With
        `sum_maps` the metric compares the sum of the data's maps with the
        sum of the template's. The metrics get no variance (the JAX
        package's template objective passes none), so the MC-uncertainty
        likelihoods take their Poisson limit here; ``generalized_poisson_llh``
        takes the pipeline's :data:`LLH_KEYS` outputs, with its recursion
        length fixed now (:meth:`_mixture_k_max`).

        `capture` (by default: as the template captures) captures the two
        functions in CUDA graphs, once, here (:class:`CapturedObjective`); a
        capture that fails raises. ``capture=False`` keeps the eager route
        on the card. ``value_only.raw`` is the objective ``(vec, los, his)
        -> value`` with the bounds as arguments, differentiable in `vec` on
        either route, for :func:`pisa_tpu_torch.analysis.device_fit.
        minimize_on_device`; ``value_only.raw_with_data`` its batched form
        over (B, n) lanes (:func:`wrap_objective`), whose data, where given,
        is (B, bins) with the data's maps laid end to end."""
        from pisa_tpu_torch.core import collectives
        from pisa_tpu_torch.utils import stats

        maximize = stats.is_metric_to_maximize(metric)
        metric_fn = stats.metric_function(metric)
        # the daemonflux switch (reference param.py:1388-1402): the free
        # daemon_* params' penalty is one correlated chi2, not their
        # individual priors
        daemon = (compiled_daemon_penalty(self._free_params, [self.pipeline])
                  if priors else None)
        daemon_skip = daemon[0] if daemon is not None else frozenset()

        device = self.pipeline.device
        if capture is None:
            capture = self.capture
        elif capture and device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device, not {device}")
        if isinstance(data_dist, MapSet):
            items = [(m.name, m.hist) for m in data_dist]
        elif isinstance(data_dist, Map):
            items = [(data_dist.name, data_dist.hist)]
        else:
            items = list(data_dist.items())
        host = {name: np.array(h, dtype=np.float64).ravel()
                for name, h in items}
        data = {name: torch.as_tensor(h, dtype=TORCH_FTYPE, device=device)
                for name, h in host.items()}
        sizes = [d.shape[0] for d in data.values()]
        generalized = metric == "generalized_poisson_llh"
        if generalized:
            k_max = self._mixture_k_max(sum(host.values()))
        # on a stacked template whose categories the data covers in order,
        # the metric is taken over the (C, size) stack in one go
        data_stacked = None
        if self.stacked and list(data) == self.names:
            data_stacked = torch.stack(list(data.values()))
        sign = 1.0 if maximize else -2.0  # llh, or chi2 = -2 llh
        mesh = self.mesh

        def objective(vec, los=None, his=None, data_arg=None):
            if mesh is not None:
                # the gradient rule of core/collectives.py: the vector's
                # gradient summed over the ranks, each rank's objective 1 /
                # world of it
                vec = collectives.sum_gradients(vec, mesh)
            mags = self._magnitudes_from_rescaled(vec, los, his)
            lanes = vec.shape[0] if vec.dim() == 2 else None
            lead = () if lanes is None else (lanes,)
            out = self._evaluate(mags, lanes)
            hists = out["hist"]
            if data_arg is None:
                datas = data
            else:  # (B, bins): the data's maps end to end, one row a lane
                datas = dict(zip(data, data_arg.split(sizes, dim=-1)))
            if generalized:
                if lanes is not None:
                    raise ValueError("generalized_poisson_llh takes no lanes")
                # per-source (S, bins) stacks of the mixture's inputs
                # (``pisa_tpu/core/template.py:681-700``)
                expected = {"weights": torch.stack(list(hists.values()))}
                for key in LLH_KEYS:
                    if key in out:  # else the metric names what is missing
                        expected[key] = torch.stack([out[key][n]
                                                     for n in hists])
                total = metric_fn(sum(datas.values()), expected,
                                  k_max=k_max).sum()
            elif sum_maps:
                total = metric_fn(sum(datas.values()),
                                  sum(hists.values())).sum(-1)
            elif data_stacked is not None:
                d = (data_stacked if data_arg is None
                     else data_arg.reshape(lead + data_stacked.shape))
                total = metric_fn(d, out["hist_stacked"]).sum((-2, -1))
            else:
                total = sum(metric_fn(d, hists[name]).sum(-1)
                            for name, d in datas.items())
            if priors:
                for i, (p, mag) in enumerate(zip(self._free_params, mags)):
                    if p.prior is None or i in daemon_skip:
                        continue
                    if p.prior.units is not None:
                        mag = Quantity(mag, p.units).m_as(p.prior.units)
                    total = total + sign * p.prior.llh_torch(mag).reshape(
                        lead)
                if daemon is not None:
                    total = total + sign * daemon[1](mags).reshape(lead)
            total = -total if maximize else total
            if mesh is not None:
                total = collectives.scale_gradient(total, 1.0 / mesh.size)
            return total

        return wrap_objective(self, objective, capture)

    def _mixture_k_max(self, data):
        """The generalized likelihood's static recursion length for the
        summed data `data` (host array), fixed when the objective is built
        (``pisa_tpu/core/template.py:672-676``): the largest count among
        the bins that take the mixture, from the MC event counts of one
        evaluation here (static, from the stages' set-up)
        (``utils/llh_defs/poisson.py:mixture_k_max``); the largest count
        where the pipeline makes no MC event counts."""
        from pisa_tpu_torch.utils.llh_defs.poisson import mixture_k_max

        with torch.no_grad():
            out = self._evaluate(self._magnitudes_from_rescaled(
                self.current_rescaled_values()))
        if "n_mc_events" not in out:
            return max(1, int(np.ceil(np.max(data))))
        n_mc = torch.stack([out["n_mc_events"][n] for n in out["hist"]])
        return mixture_k_max(data, n_mc.cpu().numpy())


def wrap_objective(owner, objective, capture):
    """``(value_fn, vg_fn)`` of the rescaled vector over ``objective(vec,
    los, his[, data])`` of a compiled template or distribution `owner`
    (which gives ``device``, ``current_rescaled_values()`` and
    ``_device_bounds()``): captured in one program on a CUDA device
    (:class:`CapturedObjective`), eager otherwise.

    ``value_fn.raw`` is the objective with the bounds as arguments,
    differentiable in `vec`, for :func:`pisa_tpu_torch.analysis.device_fit.
    minimize_on_device`. ``value_fn.raw_with_data(vec (B, n), los, his,
    data (B, bins) or None) -> (B,)`` is its batched form (B independent
    lanes; ``pisa_tpu/analysis/gradient.py:316-318``), differentiable in
    `vec`; ``None`` compares every lane with the closed-over data. On a
    CUDA device it is captured once per (B, with or without data), the data
    batch a static input of the program that a call copies in;
    ``raw_with_data.bind(data, B)`` copies it in once and returns ``(vec,
    los, his) -> (B,)`` for all the evaluations of a fit.

    Where `owner` has been sharded since (:meth:`CompiledTemplate.shard`),
    every one of these functions raises rather than evaluate the data it
    was built on."""
    device = owner.device
    generation = getattr(owner, "_generation", None)

    def fresh():
        if generation is not None and owner._generation != generation:
            raise RuntimeError(
                "this objective was built before the template was sharded;"
                " build it again")

    if capture:
        program = CapturedObjective(
            objective, owner.current_rescaled_values(),
            *owner._device_bounds(), device=device)
        vg = program.value_and_grad
        batched = {}  # (B, with data) -> CapturedObjective

        def raw(vec, los, his):
            fresh()
            return program.differentiable(vec, los, his)

        def bind_data(data, lanes):
            key = (lanes, data is not None)
            extra = () if data is None else (data,)
            if key not in batched:
                batched[key] = CapturedObjective(
                    objective,
                    np.tile(owner.current_rescaled_values(), (lanes, 1)),
                    *owner._device_bounds(), device=device, extra=extra)
            else:
                batched[key].load_extra(*extra)
            bound = batched[key]

            def raw_bound(vec, los, his):
                fresh()
                _check_lanes(vec, data, device, lanes)
                return bound.differentiable(vec, los, his)
            return raw_bound
    else:
        program = None
        batched = None

        def raw(vec, los, his):
            fresh()
            return objective(vec, los, his)

        def bind_data(data, lanes):
            def raw_bound(vec, los, his):
                fresh()
                _check_lanes(vec, data, device, lanes)
                return objective(vec, los, his, data)
            return raw_bound

        def vg(vec, los, his):
            fresh()
            vec = on_device(vec, device).detach().clone()
            vec.requires_grad_(True)
            value = objective(vec, los, his)
            (grad,) = torch.autograd.grad(value, vec)
            return value.detach(), grad

    def raw_with_data(vec, los, his, data=None):
        fresh()
        _check_lanes(vec, data, device)
        return bind_data(data, vec.shape[0])(vec, los, his)

    def value_fn(vec):
        fresh()
        with torch.no_grad():
            return raw(vec if capture else on_device(vec, device),
                       *owner._device_bounds())

    def vg_fn(vec):
        fresh()
        return vg(vec if capture else on_device(vec, device),
                  *owner._device_bounds())

    raw.device = raw_with_data.device = device
    #: the captured batched programs, by (B, with data)
    raw_with_data.programs = batched
    #: ``bind(data, lanes)``: the batched objective with `data` (B, bins)
    #: or None fixed, ``(vec, los, his) -> (B,)``; on the card the data is
    #: copied into the program once, at the bind, for a whole fit
    raw_with_data.bind = bind_data
    value_fn.raw = vg_fn.raw = raw
    value_fn.raw_with_data = vg_fn.raw_with_data = raw_with_data
    value_fn.program = vg_fn.program = program
    return value_fn, vg_fn


def _check_lanes(vec, data, device, lanes=None):
    """A batched objective takes a (B, n) tensor on its device (B = `lanes`
    where given) and (B, bins) data or None."""
    if not isinstance(vec, torch.Tensor) or vec.dim() != 2:
        raise ValueError("raw_with_data takes a (B, n) tensor of lanes; got"
                         f" {type(vec).__name__} {tuple(np.shape(vec))}")
    if lanes is not None and vec.shape[0] != lanes:
        raise ValueError(f"the objective was bound for {lanes} lanes; got"
                         f" {vec.shape[0]}")
    for x in (vec, data):
        if x is not None and x.device != device:
            raise ValueError(f"the objective lives on {device}; got a tensor"
                             f" on {x.device}")
    if data is not None and (data.dim() != 2 or data.shape[0] != vec.shape[0]):
        raise ValueError(f"data must be ({vec.shape[0]}, bins) for"
                         f" {vec.shape[0]} lanes; got {tuple(data.shape)}")


def on_device(x, device):
    """`x` (array or tensor) as a float64 tensor on `device`; a tensor that
    lies elsewhere is refused, not moved."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"the objective lives on {device}; got a tensor"
                             f" on {x.device}")
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


class _Replay(torch.autograd.Function):
    """A :class:`CapturedObjective`'s value as a node of an autograd graph:
    the forward replays the captured ``value_and_grad``, the backward
    returns the captured gradient times the cotangent (per lane, for a
    batched objective)."""

    @staticmethod
    def forward(ctx, vec, program, los, his):
        value, grad = program.value_and_grad(vec, los, his)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g.unsqueeze(-1) * grad, None, None, None


class _CapturedProgram:
    """Static input tensors on a CUDA device (``vec``, (n,) or (B, n) for B
    lanes, and the bounds ``los`` and ``his``, (n,) each, loaded at every
    call without a wait; any further input such as a data batch, loaded by
    :meth:`load_extra`), and the capture of functions of them in CUDA
    graphs.

    A function is run eagerly :data:`CAPTURE_WARMUP` times on a side stream,
    which builds every lazily cached tensor outside the graph's memory pool,
    then captured once; a capture that fails raises. The graphs read what
    the function reads (the data it closes over) where it lay at capture,
    so subclasses keep the function alive as long as the graphs."""

    def __init__(self, inputs, device):
        self.device = device
        self._static = []
        self._pinned = []
        for x in inputs:
            dtype = x.dtype if isinstance(x, torch.Tensor) else torch.float64
            shape = tuple(np.shape(x))
            self._static.append(torch.zeros(shape, dtype=dtype,
                                            device=device))
            self._pinned.append(torch.zeros(shape, dtype=dtype).pin_memory())
        self._uploaded = torch.cuda.Event()
        self._staged = None  # a pinned array on its way to the card

    def _capture(self, fn):
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(CAPTURE_WARMUP):
                fn()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        # a graph freed while another is captured breaks that capture (CUDA
        # forbids destroying it then): the garbage collector, which frees
        # programs left in reference cycles, runs before and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = fn()
        finally:
            if collecting:
                gc.enable()
        return graph, outputs

    @torch.no_grad()
    def _load(self, vec, los, his):
        """The inputs into the static tensors: a tensor (on the device) by
        a copy there, an array through the pinned buffer by a copy that the
        host does not wait for."""
        arrays = {}
        for i, x in enumerate((vec, los, his)):
            if isinstance(x, torch.Tensor):
                if x.device != self._static[i].device:
                    raise ValueError(f"the program lives on {self.device};"
                                     f" got a tensor on {x.device}")
                self._static[i].copy_(x)
            else:
                arrays[i] = np.asarray(x, dtype=np.float64)
        if not arrays:
            return
        # the last upload has left the pinned buffer before it is rewritten
        self._uploaded.synchronize()
        for i, x in arrays.items():
            self._pinned[i].copy_(torch.from_numpy(x))
            self._static[i].copy_(self._pinned[i], non_blocking=True)
        self._uploaded.record()

    @torch.no_grad()
    def load_extra(self, *extra):
        """The further inputs (tensors on the device, such as a data batch)
        into their static tensors, by copies there: once for all the
        evaluations that read them."""
        if len(extra) != len(self._static) - 3:
            raise ValueError(f"the program takes {len(self._static) - 3}"
                             f" further inputs; got {len(extra)}")
        for static, x in zip(self._static[3:], extra):
            if x.device != static.device:
                raise ValueError(f"the program lives on {self.device}; got a"
                                 f" tensor on {x.device}")
            static.copy_(x)

    def upload(self, rows):
        """`rows` (an array, or a tensor on the device) as a float64 tensor
        on the device; an array goes through pinned memory by a copy that
        the host does not wait for."""
        if isinstance(rows, torch.Tensor):
            if rows.device != self._static[0].device:
                raise ValueError(f"the program lives on {self.device}; got a"
                                 f" tensor on {rows.device}")
            return rows.to(torch.float64)
        self._uploaded.synchronize()
        self._staged = torch.from_numpy(
            np.array(rows, dtype=np.float64)).pin_memory()
        out = self._staged.to(self.device, non_blocking=True)
        self._uploaded.record()
        return out


class CapturedFunction(_CapturedProgram):
    """``fn(vec, los, his) -> tuple of tensors`` (no gradient) as one CUDA
    graph over static input tensors: the port's counterpart of ``jax.jit``
    of the template call (``pisa_tpu/core/template.py:553``). A call loads
    its inputs (:meth:`_CapturedProgram._load`) and replays; it returns the
    graph's static outputs, which the next replay overwrites (copy what you
    keep). Nothing inside waits for the card."""

    def __init__(self, fn, vec0, los, his, device):
        super().__init__((vec0, los, his), device)
        self._fn = fn
        self._load(vec0, los, his)
        vec_s, los_s, his_s = self._static

        def run():
            with torch.no_grad():
                return fn(vec_s, los_s, his_s)

        self._graph, self._outputs = self._capture(run)

    def __call__(self, vec, los, his):
        self._load(vec, los, his)
        self._graph.replay()
        return self._outputs


class CapturedObjective(_CapturedProgram):
    """``objective(vec, los, his, *extra) -> value`` and its gradient in
    `vec` as two CUDA graphs over static input tensors (the port's
    counterpart of ``jax.jit`` of the objective,
    ``pisa_tpu/core/template.py:730``).

    `vec0` is (n,), or (B, n) for a batched objective whose value is (B,)
    (B independent lanes: the gradient of the lanes' sum is each lane's
    gradient); `extra` holds further inputs of the objective, such as a
    (B, bins) data batch, which become static inputs too, loaded here and
    again by :meth:`load_extra`, not at an evaluation. The constructor
    runs ``value_and_grad`` and the value eagerly :data:`CAPTURE_WARMUP`
    times each on a side stream at these inputs, then captures each once; a
    capture that fails raises. An evaluation copies its inputs into the
    static tensors (arrays through one pinned staging buffer, without
    waiting) and replays; it
    returns copies of the static outputs, so the next replay does not
    change what the caller holds. Nothing inside waits for the card: the
    caller's read of the value is the one wait.
    """

    def __init__(self, objective, vec0, los, his, device, extra=()):
        super().__init__((vec0, los, his) + tuple(extra), device)
        # the graphs read the tensors that `objective` closes over (the
        # data) where they lay at capture: they must live as long as this
        self._objective = objective
        self._load(vec0, los, his)
        self.load_extra(*extra)
        vec_s, *rest = self._static

        def value_and_grad():
            vec = vec_s.detach().requires_grad_(True)
            value = objective(vec, *rest)
            (grad,) = torch.autograd.grad(value, vec, torch.ones_like(value))
            return value.detach(), grad

        def value_only():
            with torch.no_grad():
                return (objective(vec_s, *rest),)

        self._vg_graph, (self._value, self._grad) = self._capture(
            value_and_grad)
        self._value_graph, (self._value_only,) = self._capture(value_only)

    def value(self, vec, los, his):
        self._load(vec, los, his)
        self._value_graph.replay()
        return self._value_only.clone()

    def value_and_grad(self, vec, los, his):
        self._load(vec, los, his)
        self._vg_graph.replay()
        return self._value.clone(), self._grad.clone()

    def differentiable(self, vec, los, his):
        """The value as a tensor that autograd can differentiate in `vec`
        (``value.backward()`` gives the captured gradient), or, where no
        gradient is asked for, the value-only graph's."""
        if torch.is_grad_enabled() and isinstance(vec, torch.Tensor) \
                and vec.requires_grad:
            return _Replay.apply(vec, self, los, his)
        return self.value(vec, los, his)
