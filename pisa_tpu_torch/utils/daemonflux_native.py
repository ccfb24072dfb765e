"""
The native daemonflux stand-in (counterpart of
``pisa_tpu/utils/daemonflux_native.py``; reference
``pisa/stages/flux/daemon_flux.py`` wraps the external ``daemonflux``
package, which is installed nowhere this port runs).

daemonflux is a base flux times a LINEAR response of the flux to 24
calibration parameters (meson-production yields at fixed-target beam
energies and six GSF primary-flux parameters), with a correlated chi2
penalty. The stand-in keeps that machinery with an analytic response
model: each ``daemon_*`` parameter shifts the (nue, numu) flux
multiplicatively by a log-normal energy kernel centred at the parameter's
characteristic neutrino energy, weighted by the pion/kaon shares and the
nu/nubar channel (the JAX package's module docstring has the model). The
penalty is ``chi2(v) = v^T C^-1 v`` with C the correlation matrix of
``resources/flux/daemonflux_correlations.json`` (identity without one).

Two forms of the flux response, equal to rounding:

- :meth:`NativeDaemonFlux.modification`, the JAX package's loop over the
  24 parameters (about eight elementwise ops each): the plain version;
- :meth:`NativeDaemonFlux.response_basis`, the per-event (..., 2, 24)
  response to a unit of each parameter, built once at set-up, so that an
  evaluation is one product with the (24,) values, or with (B, 24) values
  for B lanes (:func:`modification_from_basis`). The response is linear in
  the values, so the two agree.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pisa_tpu_torch.utils.log import logging

__all__ = [
    "DAEMON_PARAM_NAMES",
    "NativeDaemonFlux",
    "compiled_daemon_penalty",
    "modification_from_basis",
    "value_vector",
]

# PISA-config-compatible names (reference daemon_flux.py:180: pi+ -> pi,
# pi- -> antipi, K+ -> K, K- -> antiK), without the 'daemon_' prefix.
DAEMON_PARAM_NAMES = [
    "K_158G", "K_2P", "K_31G",
    "antiK_158G", "antiK_2P", "antiK_31G",
    "n_158G", "n_2P",
    "p_158G", "p_2P",
    "pi_158G", "pi_20T", "pi_2P", "pi_31G",
    "antipi_158G", "antipi_20T", "antipi_2P", "antipi_31G",
    "GSF_1", "GSF_2", "GSF_3", "GSF_4", "GSF_5", "GSF_6",
]

# characteristic beam energies [GeV] per yield tag; the neutrino kernel's
# centre is E_beam / 10 (typical lab-frame energy fraction through decay)
_BEAM_E = {"31G": 31.0, "158G": 158.0, "20T": 2e4, "2P": 2e6}
# GSF band centres [GeV primary]; the neutrino centre is E_primary / 20
_GSF_E = {f"GSF_{i}": 10.0 ** (i + 1) for i in range(1, 7)}

_SIGMA_MESON = 0.02  # 1-sigma fractional flux shift of a yield param
_SIGMA_GSF = 0.015
_WIDTH_MESON = 0.6  # log10 kernel width [dex]
_WIDTH_GSF = 0.5


def _kernel(log10e, center_gev, width):
    return torch.exp(-0.5 * ((log10e - np.log10(center_gev)) / width) ** 2)


def _pion_fraction(log10e):
    """Approximate pion share of conventional nu_mu production (kaons take
    over above the pion critical energy)."""
    e = 10.0 ** log10e
    return 1.0 / (1.0 + e / 300.0)


def _selector(is_bar, anti, dtype):
    """The channel weight of a (anti-)meson yield: 1 on its own channel,
    0.3 on the other; `is_bar` a bool or a tensor of bools."""
    own, other = (1.0, 0.3) if anti else (0.3, 1.0)
    if isinstance(is_bar, torch.Tensor):
        return torch.where(is_bar, own, other).to(dtype)
    return own if is_bar else other


def _is_bar(nubar):
    if isinstance(nubar, torch.Tensor):
        return nubar < 0
    return int(nubar) < 0


def value_vector(values, names, lanes=None, dtype=torch.float64,
                 device="cpu"):
    """The parameters `names` of the dict `values` (magnitudes: numbers, or
    tensors, 0-d or (B, 1) in an evaluation of B lanes) as one (24,) or
    (B, 24) tensor of `dtype` on `device`; numbers are filled in on the
    device."""
    lead = () if lanes is None else (lanes,)
    cols = []
    for name in names:
        x = values[name]
        if isinstance(x, torch.Tensor):
            cols.append(x.reshape(lead + (1,)).to(dtype))
        else:
            cols.append(torch.full(lead + (1,), float(x), dtype=dtype,
                                   device=device))
    return torch.cat(cols, dim=-1)


def modification_from_basis(basis, v):
    """``1 + basis @ v``: the (..., 2) multiplicative (nue, numu) flux
    factors from a (..., 2, 24) response basis and (24,) values, or the (B,
    ..., 2) factors of (B, 24) values."""
    if v.dim() == 1:
        return 1.0 + basis @ v
    lead = basis.shape[:-1]
    flat = basis.reshape(-1, basis.shape[-1]) @ v.transpose(0, 1)
    return 1.0 + flat.transpose(0, 1).reshape((v.shape[0],) + tuple(lead))


def compiled_daemon_penalty(free_params, pipelines):
    """The compiled objective's counterpart of the eager
    ``ParamSet.priors_penalty`` daemonflux switch (reference
    ``param.py:1388-1402``; ``pisa_tpu/utils/daemonflux_native.py:95``):
    when a pipeline carries a daemon_flux stage, the ``daemon_*``
    parameters' penalty is ONE correlated chi2 (``v^T C^-1 v``), not their
    individual priors.

    Returns None when no pipeline has such a stage or none of its params is
    free; otherwise ``(skip_indices, llh_fn)``: the free-param indices whose
    individual priors the objective skips, and ``llh_fn(mags)`` mapping the
    free magnitudes (0-d tensors, or (B, 1) for lanes) to the joint daemon
    llh -chi2/2 in float64 (0-d, or (B,)). Fixed daemon parameters enter
    with their values at this call, as constants."""
    stage = None
    for pl in pipelines:
        for s in getattr(pl, "stages", []):
            if isinstance(getattr(s, "native", None), NativeDaemonFlux):
                stage = s
                break
        if stage is not None:
            break
    if stage is None:
        return None
    idx = {p.name: i for i, p in enumerate(free_params)}
    entries = []
    for tag in stage.native.param_names:
        pname = "daemon_" + tag
        if pname in idx:
            entries.append(("free", idx[pname]))
        else:
            entries.append(("fixed", float(
                stage.params[pname].value.m_as("dimensionless"))))
    skip = frozenset(i for kind, i in entries if kind == "free")
    if not skip:
        return None
    cinv_host = np.asarray(stage.native._cinv, dtype=np.float64)
    cinv = {}  # device -> the (24, 24) float64 C^-1 there

    def llh_fn(mags):
        first = mags[next(iter(skip))]
        lanes = first.shape[0] if first.dim() == 2 else None
        values = {k: (mags[spec] if kind == "free" else spec)
                  for k, (kind, spec) in enumerate(entries)}
        v = value_vector(values, range(len(entries)), lanes,
                         dtype=torch.float64, device=first.device)
        if first.device not in cinv:
            cinv[first.device] = torch.as_tensor(cinv_host,
                                                 device=first.device)
        chi2 = ((v @ cinv[first.device]) * v).sum(-1)
        return -0.5 * chi2

    return skip, llh_fn


class NativeDaemonFlux:
    """Analytic daemonflux stand-in: base flux times linear responses.

    Parameters
    ----------
    correlations : str or None
        Resource path of a JSON correlation matrix of the 24 parameters;
        None: identity (uncorrelated unit-sigma penalty).
    """

    param_names = list(DAEMON_PARAM_NAMES)

    def __init__(self, correlations=None):
        n = len(self.param_names)
        corr = np.eye(n)
        if correlations is not None:
            from pisa_tpu_torch.utils.resources import find_resource

            with open(find_resource(correlations)) as fh:
                cd = json.load(fh)
            for i, a in enumerate(self.param_names):
                for j, b in enumerate(self.param_names):
                    corr[i, j] = cd.get(a, {}).get(b, 1.0 if i == j else 0.0)
        self._cinv = np.linalg.inv(corr)
        logging.debug(
            "NativeDaemonFlux: %d params, %s correlations",
            n, "identity" if correlations is None else correlations,
        )

    # -- penalty -----------------------------------------------------------
    def chi2(self, values):
        """Correlated chi2 of the (24,) parameter vector (sigma units): a
        float for an array, a tensor (differentiable) for a tensor."""
        if isinstance(values, torch.Tensor):
            cinv = torch.as_tensor(self._cinv, dtype=values.dtype,
                                   device=values.device)
            return values @ cinv @ values
        v = np.asarray(values, dtype=np.float64)
        return float(v @ self._cinv @ v)

    # -- flux response -------------------------------------------------------
    def _unit_terms(self, log10e, nubar):
        """(name, r_e, r_mu) per parameter: the fractional (nue, numu) flux
        shifts per unit of it, as the JAX package's loop forms them."""
        is_bar = _is_bar(nubar)
        f_pi = _pion_fraction(log10e)
        f_k = 1.0 - f_pi
        for name in self.param_names:
            tag = name.split("_", 1)[-1]
            if name.startswith("GSF"):
                g = _SIGMA_GSF * _kernel(log10e, _GSF_E[name] / 20.0,
                                         _WIDTH_GSF)
                yield name, g, g
                continue
            g = _SIGMA_MESON * _kernel(log10e, _BEAM_E[tag] / 10.0,
                                       _WIDTH_MESON)
            # anti-meson yields drive the antineutrino channels
            sel = _selector(is_bar, name.startswith("anti"), g.dtype)
            if name.startswith(("pi", "antipi")):
                yield name, g * sel * f_pi * 0.3, g * sel * f_pi
            elif name.startswith(("K", "antiK")):
                # K_e3 dominates conventional nu_e
                yield name, g * sel, g * sel * f_k
            else:  # p_* / n_* beam-nucleon yields: all channels
                yield name, g, g

    def modification(self, log10e, nubar, values):
        """Multiplicative flux factors for one (nue, numu) channel pair,
        the JAX package's loop form (the plain version).

        Parameters
        ----------
        log10e : (...,) tensor, log10 of the neutrino energy [GeV] (pads
            sanitized)
        nubar : +1 / -1, or a tensor of signs broadcastable to `log10e`
        values : dict name -> magnitude (number or tensor), sigma units

        Returns
        -------
        (mod_e, mod_mu), each broadcast from `log10e` and the values.
        """
        d_e = torch.zeros_like(log10e)
        d_mu = torch.zeros_like(log10e)
        for name, r_e, r_mu in self._unit_terms(log10e, nubar):
            v = values[name]
            d_e = d_e + r_e * v
            d_mu = d_mu + r_mu * v
        return 1.0 + d_e, 1.0 + d_mu

    def response_basis(self, log10e, nubar):
        """The (..., 2, 24) response of the (nue, numu) flux factors to a
        unit of each parameter, in :attr:`param_names` order: with it the
        factors are ``modification_from_basis(basis, v)``."""
        cols = [torch.stack(torch.broadcast_tensors(r_e, r_mu), dim=-1)
                for _, r_e, r_mu in self._unit_terms(log10e, nubar)]
        return torch.stack(cols, dim=-1)
