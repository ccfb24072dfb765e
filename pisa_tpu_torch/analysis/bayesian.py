"""
Bayesian posterior sampling: the Goodman & Weare (2010) affine-invariant
ensemble sampler ("stretch move").

Counterpart of ``pisa_tpu/analysis/bayesian.py`` (reference
``pisa/analysis/bayesian_analysis.py:23``, serial emcee fed by a TCP
llh-server farm). A half-ensemble step is one evaluation of the compiled
template's objective over ``n_walkers/2`` lanes (``value_fn.raw_with_data``
bound once, without a gradient; on a CUDA device one replay of a captured
program, in which each chain kernel launches once per neutrino sign for
all the walkers). The random numbers come from a seeded
``torch.Generator`` on the objective's device, the walkers, the chain and
the count of acceptances stay there, and the host reads them once, at the
end: no step waits for the card.

Sampling happens in the minimizer's rescaled [0, 1] space (a flat prior
over the param ranges; Param priors enter through the objective's
penalty); a proposal outside the box is rejected.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mcmc_sampling", "MCMC_sampling", "batched_log_prob"]


def batched_log_prob(compiled_template, data_dist, metric, lanes):
    """The log posterior ``x (lanes, n) -> (lanes,)`` of the compiled
    template against `data_dist` under `metric` (the negated objective of
    :meth:`CompiledTemplate.build_objective`, priors included), -inf for a
    point outside [0, 1]^n; `x` is a float64 tensor on the template's
    device. No gradient is taken."""
    ct = compiled_template
    value_fn, _ = ct.build_objective(data_dist, metric)
    objective = value_fn.raw_with_data.bind(None, lanes)

    def log_prob(x):
        inside = ((x >= 0.0) & (x <= 1.0)).all(-1)
        with torch.no_grad():
            lp = -objective(x.clamp(0.0, 1.0), *ct._device_bounds())
        return torch.where(inside, lp, torch.full_like(lp, -torch.inf))

    return log_prob


def mcmc_sampling(
    compiled_template,
    data_dist,
    metric="llh",
    n_walkers=32,
    n_steps=500,
    n_burnin=100,
    stretch_a=2.0,
    seed=0,
    x0=None,
    init_spread=0.05,
):
    """Sample the posterior of a compiled template's free parameters.

    Parameters
    ----------
    compiled_template : CompiledTemplate
    data_dist : MapSet or dict, the data distribution
    metric : str, an llh-family metric (the objective is -log posterior)
    n_walkers : int (even)
    n_steps : int, the steps recorded after the burn-in
    n_burnin : int
    stretch_a : float, the stretch move's scale
    seed : int
    x0 : (n_params,) rescaled start (default: the current values)
    init_spread : float, the width of the walkers' starting ball

    Returns
    -------
    chain : (n_steps, n_walkers, n_params) rescaled samples (numpy)
    logp : (n_steps, n_walkers)
    acceptance : float, the mean acceptance fraction
    """
    if n_walkers % 2:
        raise ValueError("n_walkers must be even")
    ct = compiled_template
    half = n_walkers // 2
    log_prob = batched_log_prob(ct, data_dist, metric, half)
    device = ct.device
    n_params = len(ct.free_names)
    if x0 is None:
        x0 = ct.current_rescaled_values()
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64), **f64)
    walkers = torch.clamp(
        x0 + init_spread * torch.randn((n_walkers, n_params), generator=gen,
                                       **f64),
        1e-4, 1.0 - 1e-4)
    lp = torch.cat([log_prob(walkers[:half]), log_prob(walkers[half:])])
    n_acc = torch.zeros((), dtype=torch.int64, device=device)
    chain = torch.empty((n_steps, n_walkers, n_params), **f64)
    chain_lp = torch.empty((n_steps, n_walkers), **f64)
    for step in range(n_burnin + n_steps):
        for first in (0, half):
            # the moving half S and its complement C
            moving = slice(first, first + half)
            movers, movers_lp = walkers[moving], lp[moving]
            others = walkers[half - first:2 * half - first]
            # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a]
            u = torch.rand(half, generator=gen, **f64)
            z = ((stretch_a - 1.0) * u + 1.0) ** 2 / stretch_a
            partners = others[torch.randint(0, half, (half,), generator=gen,
                                            device=device)]
            proposal = partners + z[:, None] * (movers - partners)
            prop_lp = log_prob(proposal)
            log_ratio = (n_params - 1) * torch.log(z) + prop_lp - movers_lp
            accept = torch.log(torch.rand(half, generator=gen, **f64)) \
                < log_ratio
            walkers[moving] = torch.where(accept[:, None], proposal, movers)
            lp[moving] = torch.where(accept, prop_lp, movers_lp)
            n_acc += accept.sum()
        if step >= n_burnin:
            chain[step - n_burnin] = walkers
            chain_lp[step - n_burnin] = lp
    # the one read of the run
    host = torch.cat([chain.reshape(-1), chain_lp.reshape(-1),
                      n_acc.reshape(1).to(torch.float64)]).cpu().numpy()
    n_chain = chain.numel()
    acceptance = float(host[-1]) / ((n_burnin + n_steps) * n_walkers)
    return (host[:n_chain].reshape(chain.shape),
            host[n_chain:-1].reshape(chain_lp.shape), acceptance)


# the reference's name (``bayesian_analysis.py:23``)
MCMC_sampling = mcmc_sampling
