"""
Bounded minimization of a template objective with its state on the device.

Counterpart of ``minimize_on_device`` in ``pisa_tpu/analysis/device_fit.py``.
The [0, 1] box of rescaled params (``Param._rescaled_value``) is enforced by
optimizing an unconstrained vector z with x = sigmoid(z), so the objective
never sees out-of-box corners; boundary optima are approached
asymptotically. The optimizer is L-BFGS with a strong-Wolfe line search
(``torch.optim.LBFGS``); its state (z, the curvature history, the gradient)
and the bounds live on the device the caller names (``"cuda"`` by default,
as every entry point of the port), which must be the objective's: nothing
falls back to the CPU. The objective may be a captured one
(``core/template.py:CapturedObjective``): its value carries the captured
gradient into ``backward()``. Unlike the JAX package's single-dispatch
``lax.while_loop``, ``torch.optim.LBFGS`` reads each objective value and
its own convergence tests back to the host (several waits per evaluation).

The vmapped ``fit_batch_on_device`` and ``fit_pseudo_ensemble`` are not
ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.container import resolve_device

__all__ = ["minimize_on_device", "DEFAULT_GTOL"]

_EPS = 1e-6  # sigmoid clip for the initial logit transform

# Default gradient stopping tolerance (pisa_tpu/analysis/device_fit.py:48):
# at float32 the objective's gradient noise floor sits around 1e-4, so
# insisting on 1e-6 just burns the whole max_steps budget after convergence.
DEFAULT_GTOL = 1e-6 if FTYPE == np.float64 else 3e-4


def _to_z(x, device):
    x = torch.clamp(torch.as_tensor(np.asarray(x, dtype=np.float64),
                                    device=device), _EPS, 1.0 - _EPS)
    return torch.log(x) - torch.log1p(-x)


def _guard(value):
    """Replace a non-finite objective value so that the line search
    backtracks instead of stalling (``device_fit.py:60-69``)."""
    return torch.where(torch.isfinite(value), value,
                       torch.full_like(value, 1e30))


def minimize_on_device(raw_objective, x0, los, his, max_steps=200, gtol=None,
                       device="cuda"):
    """One complete bounded fit.

    Parameters
    ----------
    raw_objective : callable
        ``(vec, los, his) -> scalar tensor`` (always minimized), e.g.
        ``value_fn.raw`` from :meth:`CompiledTemplate.build_objective`.
    x0 : array (n_free,)
        Start point in the [0, 1] rescaled space.
    los, his : arrays (n_free,)
        The current physical bounds, passed through to the objective as
        float64 tensors on `device`.
    max_steps : int
        Most L-BFGS iterations (and at most 3 objective evaluations per
        iteration on average, counting the line searches).
    gtol : float
        Stop when the largest gradient component (in z) is below it.
    device : torch.device or str
        Where the fit state lives and the objective is evaluated. A CUDA
        device without a card raises, and so does an objective whose
        ``device`` attribute names another device.

    Returns
    -------
    dict with ``x`` ([0, 1] space, numpy), ``fun``, ``nit`` and ``nfev``
    (objective evaluations; host values).
    """
    if gtol is None:
        gtol = DEFAULT_GTOL
    device = resolve_device(device)
    objective_device = getattr(raw_objective, "device", None)
    if objective_device is not None and (
            resolve_device(objective_device) != device):
        raise ValueError(f"the objective lives on {objective_device}, the fit"
                         f" was asked for on {device}")
    los, his = (torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
                for b in (los, his))
    z = _to_z(x0, device).requires_grad_(True)
    opt = torch.optim.LBFGS(
        [z], lr=1.0, max_iter=int(max_steps), max_eval=3 * int(max_steps),
        tolerance_grad=float(gtol),
        tolerance_change=1e-12, history_size=10,
        line_search_fn="strong_wolfe",
    )

    def closure():
        opt.zero_grad()
        value = _guard(raw_objective(torch.sigmoid(z), los, his))
        value.backward()
        return value

    opt.step(closure)
    with torch.no_grad():
        x = torch.sigmoid(z)
        fun = _guard(raw_objective(x, los, his))
    return {
        "x": x.cpu().numpy().astype(np.float64),
        "fun": float(fun),
        "nit": int(opt.state[z].get("n_iter", 0)),
        "nfev": int(opt.state[z].get("func_evals", 0)),
    }
