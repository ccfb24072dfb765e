"""
Stage base class (counterpart of ``pisa_tpu/core/stage.py``; reference
``pisa/core/stage.py:26``).

A Stage is one step of a pipeline (a "service"): ``setup_function`` runs once
(load events, precompute geometry), ``compute_function`` re-runs when params
change (physics factors), ``apply_function`` runs every evaluation (weight
multiplication). ``compute`` is cached on the params hash exactly like the
reference (``stage.py:536-557``), except in template mode
(``_template_mode``, set by ``core/template.py`` while it evaluates), where
params hold tensors that carry the autograd graph and every compute runs.

A stage whose params steer host-side precomputation lists them in
``host_param_names``; a compiled template refuses them as free params. A
stage that can run on a category-stacked container
(``core/stacking.py``) says so through ``supports_stacked``/``stacked_ok``,
and through the rate-deferral hooks whether it keeps the contract under
which the oscillation stage may hand its grid rate to the histogram
(``core/template.py:_setup_rate_deferral``).

A free parameter's magnitude that meets the containers' data in a stage's
arithmetic goes through :func:`in_data_type`.
"""

from __future__ import annotations

import time

import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.param import ParamSelector, ParamSet
from pisa_tpu_torch.utils.log import logging

__all__ = ["Stage", "in_data_type"]


def in_data_type(value):
    """A parameter magnitude for arithmetic with the containers' data: a
    tensor (a compiled template's float64 magnitude, 0-d, or (B, 1) in an
    evaluation of lanes) cast to the data's ``TORCH_FTYPE``, a host number
    unchanged. A 0-d tensor would take the data's type by PyTorch's
    promotion rules anyway; a (B, 1) one would instead promote float32 data
    to float64, and then a lane would not compute what its single point
    does."""
    return value.to(TORCH_FTYPE) if isinstance(value, torch.Tensor) else value


class Stage:
    """Base class for all services.

    ``host_param_names``: params whose effects run through host-side
    precomputation (geometry, files, seeds), which a compiled template
    cannot differentiate.

    Parameters
    ----------
    data : ContainerSet, optional
    params : ParamSet, ParamSelector, or sequence, optional
    expected_params : sequence of str
        Param names this service requires.
    expected_container_keys : sequence of str
        Container variables this service expects to exist.
    error_method : None or str (e.g. 'sumw2')
    calc_mode : 'events' or MultiDimBinning, optional
        Representation selected before compute_function.
    apply_mode : 'events' or MultiDimBinning, optional
        Representation selected before apply_function.
    profile : bool
        Record the host time of each setup, compute and apply
        (``setup_times``, ``calc_times``, ``apply_times``; outside template
        mode). On a CUDA device this is the time to enqueue the work.
    """

    def __init__(
        self,
        data=None,
        params=None,
        expected_params=None,
        expected_container_keys=None,
        error_method=None,
        calc_mode=None,
        apply_mode=None,
        profile=False,
    ):
        module_path = self.__class__.__module__.split(".")
        self.stage_name = module_path[-2] if len(module_path) >= 2 else ""
        self.service_name = self.__class__.__name__
        self.data = data
        self.error_method = error_method
        self.calc_mode = calc_mode
        self.apply_mode = apply_mode
        self.expected_container_keys = tuple(expected_container_keys or ())

        if isinstance(params, ParamSelector):
            self._param_selector = params
        elif isinstance(params, ParamSet):
            self._param_selector = ParamSelector(regular_params=params)
        elif params is None:
            self._param_selector = ParamSelector()
        else:
            self._param_selector = ParamSelector(regular_params=ParamSet(params))

        self.expected_params = tuple(expected_params or ())
        self._check_params()
        self.param_hash = None
        self._template_mode = False  # bypasses the compute cache
        self.profile = profile
        self.setup_times = []
        self.calc_times = []
        self.apply_times = []

    host_param_names = ()

    #: the service's compute/apply functions handle a StackedContainer
    #: (``core/stacking.py``); a compiled template stacks the categories
    #: only when every traced stage says so
    supports_stacked = False

    def stacked_ok(self):
        """Whether this instance, with its modes, can run on a stacked
        ContainerSet; override where that depends on the modes."""
        return self.supports_stacked

    def prepare_stacked(self, data):
        """Hook: one-time precomputation on the freshly stacked ContainerSet
        `data` (cached one-hot matrices, parameter-free fields), called by
        the compiled template before its first evaluation."""

    def stacking_exclude_keys(self):
        """Container keys to leave out of the stacked copy: per-container
        helper arrays whose leading axis is not the event axis, which cannot
        be padded and stacked and which the stacked path does not read."""
        return ()

    #: Rate-deferral contract: True says that the stage may run in a
    #: template whose oscillation stage hands the flux x probability rate to
    #: the histogram stage as a grid-level factor: it never touches the
    #: events representation's 'weights', or applies at a binned
    #: representation only, or multiplies the event weights by (a static
    #: per-event field) x (a scalar per category). Any traced stage that
    #: does not declare it disables deferral.
    stacked_rate_defer_safe = False

    #: container keys of the static per-event factors this stage multiplies
    #: into 'weights' (aeff's 'weighted_aeff'); they are folded into the
    #: factorized histogram's matrices at set-up
    stacked_static_weight_keys = ()

    def stacked_rate_defer_ok(self):
        """Whether this instance, with its modes, keeps the rate-deferral
        contract; override where that depends on the modes."""
        return self.stacked_rate_defer_safe

    #: the stage may run in a sharded template (``parallel/sharding.py``),
    #: where its containers hold one rank's slice of the events: everything
    #: it does is per event, or per point of a binning, or a histogram whose
    #: ranks' parts it sums (``stages/utils/hist.py``), and what it keeps on
    #: the host per container tells one rank's slice from another's. A
    #: compiled template shards only when every traced stage says so.
    supports_shard = False

    # -- params ---------------------------------------------------------------
    @property
    def params(self) -> ParamSet:
        return self._param_selector.params

    @property
    def param_selections(self):
        return self._param_selector.param_selections

    def select_params(self, selections, error_on_missing=False):
        self._param_selector.select_params(
            selections, error_on_missing=error_on_missing
        )
        self._check_params()

    def _check_params(self):
        have = set(self.params.names)
        want = set(self.expected_params)
        missing = want - have
        if missing:
            raise ValueError(
                f"{self.stage_name}.{self.service_name}: missing expected"
                f" params {sorted(missing)} (have {sorted(have)})"
            )
        if have - want:
            logging.debug(
                "%s.%s: unused params %s",
                self.stage_name,
                self.service_name,
                sorted(have - want),
            )

    def _check_exp_keys_in_data(self):
        if self.data is None or not self.expected_container_keys:
            return
        for container in self.data:
            missing = [
                k for k in self.expected_container_keys if k not in container
            ]
            if missing:
                logging.debug(
                    "%s.%s: container %r missing expected keys %s",
                    self.stage_name, self.service_name, container.name,
                    missing,
                )
                return

    # -- lifecycle ------------------------------------------------------------
    @property
    def is_map(self):
        return isinstance(self.calc_mode, MultiDimBinning)

    def setup(self):
        if self.data is None:
            raise ValueError(f"{self}: no data container set")
        if self.calc_mode is not None:
            self.data.representation = self.calc_mode
        self._timed(self.setup_function, self.setup_times)
        self._check_exp_keys_in_data()

    def _timed(self, fn, times):
        if not self.profile or self._template_mode:
            fn()
            return
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)

    def setup_function(self):
        """Override: one-time setup."""

    def compute(self):
        if len(self.params) == 0 and len(self.expected_container_keys) == 0:
            return
        if not self._template_mode:
            new_param_hash = self.params.values_hash
            if new_param_hash is not None and new_param_hash == self.param_hash:
                logging.trace("cached %s.compute", self.service_name)
                return
        if self.calc_mode is not None:
            self.data.representation = self.calc_mode
        self._timed(self.compute_function, self.calc_times)
        if not self._template_mode:
            self.param_hash = self.params.values_hash

    def compute_function(self):
        """Override: parameter-dependent computation."""

    def apply(self):
        if self.apply_mode is not None:
            self.data.representation = self.apply_mode
        self._timed(self.apply_function, self.apply_times)

    def apply_function(self):
        """Override: per-evaluation application (weights *= ...)."""

    def run(self):
        self.compute()
        self.apply()

    def __str__(self):
        return f"{self.stage_name}.{self.service_name}"

    @property
    def has_calc_mode(self):
        return self.calc_mode is not None

    @property
    def has_apply_mode(self):
        return self.apply_mode is not None

    __repr__ = __str__
