"""
Fisher-matrix sensitivities and the linearized "pull" method.

Counterpart of ``pisa_tpu/analysis/fisher.py`` (reference
``pisa/utils/fisher_matrix.py`` and ``pisa/utils/pull_method.py``). The
template's Jacobian in the free parameters is exact: one
``torch.func.jacfwd`` of the compiled template's eager function, whose
oscillation stage takes its tangents from the kernels through
``OscProbs.jvp`` (all the directions of one neutrino sign in one
multitangent launch). A captured program has no forward mode, so the
Jacobian runs eagerly, which is fine for a one-off.

Conventions: the Poisson Fisher information of a binned template mu(p) is
F_ij = sum_b (1/mu_b) dmu_b/dp_i dmu_b/dp_j; Gaussian priors add
delta_ij / sigma_i^2. Derivatives are in the physical magnitudes (the
chain rule from the rescaled [0, 1] space).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.utils.jsons import from_json, to_json

__all__ = ["FisherMatrix", "get_fisher_matrix", "calculate_pulls"]


def _template_jacobian(compiled_template, rescaled_vec=None):
    """(total template (bins,), Jacobian (bins, n_params)) in the rescaled
    space, as host arrays: the categories' histograms end to end in the
    order of their sorted names (``pisa_tpu/analysis/fisher.py:30``)."""
    ct = compiled_template
    los, his = ct._device_bounds()

    def total_hist(vec):
        out = ct._evaluate(ct._magnitudes_from_rescaled(vec, los, his))
        hist = torch.cat([h.reshape(-1) for _, h in
                          sorted(out["hist"].items())])
        return hist, hist  # the Jacobian's function, and the template

    if rescaled_vec is None:
        rescaled_vec = ct.current_rescaled_values()
    vec = torch.as_tensor(np.asarray(rescaled_vec, dtype=np.float64),
                          device=ct.device)
    jac, mu = torch.func.jacfwd(total_hist, has_aux=True)(vec)
    return (mu.detach().double().cpu().numpy(),
            jac.detach().double().cpu().numpy())


def _rescale_derivatives(compiled_template):
    """d(physical magnitude)/d(rescaled value) of each free param at its
    current value (exact on a linear range, local on a log one)."""
    los, his = compiled_template._current_bounds()
    out = []
    for lo, hi, log_scale, p in zip(los, his, compiled_template._log_scaled,
                                    compiled_template._free_params):
        if log_scale:
            # mag = lo * exp(v * ln(hi/lo)) -> d mag/dv = mag * ln(hi/lo)
            out.append(abs(p.value.magnitude * np.log(abs(hi) / abs(lo))))
        else:
            out.append(hi - lo)
    return np.asarray(out, dtype=np.float64)


def _physical_jacobian(compiled_template, rescaled_vec):
    mu, jac = _template_jacobian(compiled_template, rescaled_vec)
    jac_phys = jac / _rescale_derivatives(compiled_template)[None, :]
    inv_mu = np.where(mu > 0, 1.0 / np.clip(mu, 1e-300, None), 0.0)
    return mu, jac_phys, inv_mu


def get_fisher_matrix(compiled_template, priors=True, rescaled_vec=None):
    """The Poisson Fisher matrix of a compiled template at its current (or
    the given rescaled) point: a :class:`FisherMatrix`; Gaussian priors of
    the free params are added with `priors`."""
    _, jac_phys, inv_mu = _physical_jacobian(compiled_template, rescaled_vec)
    fisher = np.einsum("b,bi,bj->ij", inv_mu, jac_phys, jac_phys)
    params = compiled_template._free_params
    fm = FisherMatrix(
        matrix=fisher,
        parameters=list(compiled_template.free_names),
        best_fits=[p.value.magnitude for p in params],
        units=[str(p.units) for p in params],
    )
    if priors:
        for p in params:
            if p.prior is not None and getattr(p.prior, "kind", "") == "gaussian":
                sigma = p.prior.stddev
                fm.add_prior(p.name, float(getattr(sigma, "magnitude", sigma)))
    return fm


def calculate_pulls(compiled_template, data_dist, rescaled_vec=None):
    """Linearized best-fit shifts of the free params (the "pull method",
    reference ``pull_method.py``): dp = F^-1 b with b_i = sum_b (d_b -
    mu_b)/mu_b dmu_b/dp_i. Returns {name: shift} in the params' physical
    units."""
    mu, jac_phys, inv_mu = _physical_jacobian(compiled_template, rescaled_vec)
    if hasattr(data_dist, "names"):  # MapSet
        names = sorted(compiled_template.names or data_dist.names)
        d = np.concatenate([np.ravel(np.asarray(data_dist[n].hist))
                            for n in names])
    else:
        d = np.concatenate([np.ravel(np.asarray(v))
                            for _, v in sorted(data_dist.items())])
    fisher = np.einsum("b,bi,bj->ij", inv_mu, jac_phys, jac_phys)
    b = np.einsum("b,bi->i", (d - mu) * inv_mu, jac_phys)
    return dict(zip(compiled_template.free_names, np.linalg.solve(fisher, b)))


class FisherMatrix:
    """A Fisher matrix with its parameters' bookkeeping (reference
    ``fisher_matrix.py``; ``pisa_tpu/analysis/fisher.py:123``)."""

    def __init__(self, matrix, parameters, best_fits, units=None, priors=None):
        self.matrix = np.asarray(matrix, dtype=np.float64)
        self.parameters = list(parameters)
        self.best_fits = [float(b) for b in best_fits]
        self.units = list(units) if units else [""] * len(self.parameters)
        if self.matrix.shape != (len(self.parameters),) * 2:
            raise ValueError("matrix shape does not match parameters")
        if priors:
            for name, sigma in priors.items():
                self.add_prior(name, sigma)

    # -- bookkeeping -----------------------------------------------------------
    def index(self, name):
        return self.parameters.index(name)

    def add_prior(self, name, sigma):
        """A Gaussian prior of width `sigma` on parameter `name`."""
        i = self.index(name)
        self.matrix[i, i] += 1.0 / float(sigma) ** 2

    def remove_parameter(self, name):
        """Marginalize a parameter out: drop its row and column of the
        covariance (invert, delete, invert again)."""
        i = self.index(name)
        cov = np.delete(np.delete(self.covariance(), i, 0), i, 1)
        del self.parameters[i], self.best_fits[i], self.units[i]
        self.matrix = np.linalg.inv(cov)

    def fix_parameter(self, name):
        """Condition on a parameter: drop its row and column of the Fisher
        matrix."""
        i = self.index(name)
        self.matrix = np.delete(np.delete(self.matrix, i, 0), i, 1)
        del self.parameters[i], self.best_fits[i], self.units[i]

    # -- uncertainties ------------------------------------------------------------
    def covariance(self):
        return np.linalg.inv(self.matrix)

    def correlation(self):
        cov = self.covariance()
        s = np.sqrt(np.diag(cov))
        return cov / np.outer(s, s)

    def get_sigma(self, name, marginalized=True):
        """The 1-sigma uncertainty: marginalized (from the covariance), or
        with every other parameter fixed (1/sqrt(F_ii))."""
        i = self.index(name)
        if marginalized:
            return float(np.sqrt(self.covariance()[i, i]))
        return float(1.0 / np.sqrt(self.matrix[i, i]))

    # -- serialization -------------------------------------------------------------
    @property
    def state(self):
        return {
            "matrix": self.matrix,
            "parameters": self.parameters,
            "best_fits": self.best_fits,
            "units": self.units,
        }

    def to_json(self, path):
        to_json(self.state, path)

    @classmethod
    def from_json(cls, path):
        return cls(**from_json(path))

    def __str__(self):
        lines = ["FisherMatrix:"]
        for name in self.parameters:
            lines.append(
                f"  {name}: sigma(marg)={self.get_sigma(name):.4g},"
                f" sigma(fixed)={self.get_sigma(name, False):.4g}"
            )
        return "\n".join(lines)
