"""
DAEMONFLUX atmospheric flux (counterpart of
``pisa_tpu/stages/flux/daemon_flux.py``; reference
``pisa/stages/flux/daemon_flux.py``): the data-driven flux with 24
correlated ``daemon_*`` calibration parameters (meson-production yields and
GSF primary-flux parameters) and a ``daemon_chi2`` covariance penalty
(reference ``param.py:1388`` replaces the daemon params' individual priors
by that one chi2).

The external ``daemonflux`` package is installed neither here nor on the
card machine, so the stage runs the native analytic stand-in
(:mod:`pisa_tpu_torch.utils.daemonflux_native`), as the JAX package does
without the package, and logs the same warning. The package route is not
ported.

Set-up stores per event the Honda 2015 base flux (``daemon_base_flux``,
(n, 2)), ``daemon_log10e`` and the response basis ``daemon_response`` (n,
2, 24): the flux's linear response to a unit of each parameter. A compute
is then ``nu_flux = base * (1 + response @ v)``, one product with the (24,)
values, or with (B, 24) values in an evaluation of B lanes. The same code
runs per container and on a category-stacked container (``core/
stacking.py``), where the keys are (C, n_pad, ...) and the basis carries
each category's nubar sign. The JAX package's loop over the 24 parameters
stays as the plain version (``NativeDaemonFlux.modification``), which the
tests hold the basis against.

The correlation file defaults to the vendored
``flux/daemonflux_correlations.json`` (the JAX package's module docstring
says how it was built); ``correlations_file='identity'`` gives the
uncorrelated ``sum v_i^2``.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.param import Param, ParamSelector, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.daemonflux_native import (
    DAEMON_PARAM_NAMES,
    NativeDaemonFlux,
    modification_from_basis,
    value_vector,
)
from pisa_tpu_torch.utils.flux_weights import (
    calculate_2d_flux_weights,
    load_2d_table,
)
from pisa_tpu_torch.utils.log import logging

__all__ = ["daemon_flux", "init_test"]

_BASE_TABLE = "flux/honda-2015-spl-solmin-aa.d"


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class daemon_flux(Stage):  # noqa: N801
    """Params: the 24 ``daemon_*`` (sigma units), ``daemon_chi2`` (an
    output) and ``daemon_params_len`` (a guard, cf. reference
    ``pipeline.py:125``)."""

    # the per-event base flux, log10(E) and response basis stack to (C,
    # n_pad, ...); the response math is shape-agnostic
    supports_stacked = True

    # writes nu_flux only; never touches the event weights
    stacked_rate_defer_safe = True

    #: the default vendored correlation matrix
    VENDORED_CORRELATIONS = "flux/daemonflux_correlations.json"

    def __init__(self, correlations_file=VENDORED_CORRELATIONS,
                 calibration_file=None, **std_kwargs):
        if correlations_file == "identity":
            correlations_file = None
        self.cal_file = calibration_file
        try:
            import daemonflux  # noqa: F401
        except ImportError:
            logging.warning(
                "daemonflux package not installed: flux.daemon_flux runs the"
                " NATIVE analytic stand-in (pisa_tpu_torch/utils/"
                "daemonflux_native.py) — same machinery, approximate"
                " response shapes; install daemonflux for calibrated physics"
            )
        else:
            logging.warning(
                "flux.daemon_flux: the daemonflux package route is not"
                " ported; running the NATIVE analytic stand-in"
            )
        self.native = NativeDaemonFlux(correlations=correlations_file)
        self.daemon_params = ["daemon_" + t for t in DAEMON_PARAM_NAMES]

        # the bookkeeping params (cf. reference daemon_flux.py:188-207):
        # daemon_chi2 carries the covariance penalty for the eager
        # ParamSet.priors_penalty switch
        params = std_kwargs.get("params")
        if isinstance(params, (ParamSet, ParamSelector)):
            params.update(
                Param(name="daemon_chi2", value=0.0 * ureg.dimensionless,
                      prior=None, range=None, is_fixed=True),
                existing_must_match=False,
            )
            params.update(
                Param(name="daemon_params_len",
                      value=float(len(self.daemon_params) + 2)
                      * ureg.dimensionless,
                      prior=None, range=None, is_fixed=True),
                existing_must_match=False,
            )

        super().__init__(
            expected_params=tuple(
                self.daemon_params + ["daemon_chi2", "daemon_params_len"]
            ),
            expected_container_keys=("true_energy", "true_coszen", "nubar"),
            **std_kwargs,
        )

    # -- setup ---------------------------------------------------------------
    def setup_function(self):
        """The per-event base flux (the Honda 2015 table), the sanitized
        log10(E) and the response basis, once."""
        honda = load_2d_table(_BASE_TABLE)
        for container in self.data:
            e = _host(container["true_energy"])
            cz = np.clip(_host(container["true_coszen"]), -1.0, 1.0)
            nubar = int(container["nubar"])
            sfx = "" if nubar > 0 else "bar"
            base = np.empty((e.size, 2), dtype=FTYPE)
            base[:, 0] = calculate_2d_flux_weights(e, cz, honda[f"nue{sfx}"])
            base[:, 1] = calculate_2d_flux_weights(e, cz, honda[f"numu{sfx}"])
            log10e = np.log10(np.where(np.isfinite(e) & (e > 0), e, 1.0))
            container["daemon_base_flux"] = base
            container["daemon_log10e"] = log10e.astype(FTYPE)
            container["daemon_response"] = self.native.response_basis(
                torch.as_tensor(log10e, device=self.data.device),
                nubar).to(TORCH_FTYPE)

    # -- compute ---------------------------------------------------------------
    def _param_values(self):
        return {
            tag: self.params[pname].value.m_as("dimensionless")
            for tag, pname in zip(DAEMON_PARAM_NAMES, self.daemon_params)
        }

    def compute_function(self):
        values = self._param_values()
        if not any(isinstance(v, torch.Tensor) for v in values.values()):
            # eager bookkeeping: the covariance chi2 that
            # ParamSet.priors_penalty reads (a compiled objective adds the
            # same chi2 itself, core/template.py)
            self.params["daemon_chi2"]._value = self.native.chi2(
                [float(values[k]) for k in DAEMON_PARAM_NAMES]
            ) * ureg.dimensionless

        v = value_vector(values, DAEMON_PARAM_NAMES, self.data.lanes,
                         dtype=TORCH_FTYPE, device=self.data.device)
        for container in self.data:
            basis = container["daemon_response"]
            if self.data.lanes is not None:
                basis = basis[0]  # static: a broadcast view over the lanes
            container["nu_flux"] = (container["daemon_base_flux"]
                                    * modification_from_basis(basis, v))


def init_test(**param_kwargs):
    """Instantiation example (native fallback; no external dependency)."""
    params = [
        Param(
            name=f"daemon_{tag}", value=0.0 * ureg.dimensionless,
            **param_kwargs,
        )
        for tag in DAEMON_PARAM_NAMES
    ]
    return daemon_flux(params=ParamSet(params), calc_mode="events")
