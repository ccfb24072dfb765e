"""
Bounded minimization of a template objective with its state on the device.

Counterpart of ``pisa_tpu/analysis/device_fit.py``. The [0, 1] box of
rescaled params (``Param._rescaled_value``) is enforced by optimizing an
unconstrained vector z with x = sigmoid(z), so the objective never sees
out-of-box corners; boundary optima are approached asymptotically.

The optimizer is the JAX package's: ``optax.lbfgs()`` with its defaults
(optax 0.2.6: memory 10, ``scale_init_precond``, the zoom line search of
``optax/_src/linesearch.py`` with at most 20 steps and the initial guess
``'one'``), stopped as ``pisa_tpu/analysis/device_fit.py:93-99`` stops it,
when the gradient's L2 norm falls below ``gtol`` or the iteration count
reaches ``max_steps``. :func:`lbfgs_while` computes the same states in the
same order with torch ops; optax is not imported. The state (z, the s/y
history, the value and gradient, the line search's interval, reference
points and flags) lives on the objective's device, and every decision inside
an iteration is a ``torch.where`` over 0-d tensors. Where the reference's
``lax.while_loop`` and ``lax.cond`` branch, the host reads one small flag
tensor per objective evaluation: whether the line search goes on, whether
it zooms, and whether the fit goes on.

Each update is written with elementwise ops and reductions over the last
axis, so a leading lane axis runs B independent fits in one loop
(:func:`fit_batch_on_device`, :func:`fit_pseudo_ensemble`: the counterpart
of ``jax.vmap`` over ``lbfgs_while``), over a batched objective that
evaluates all lanes in one program (``value_fn.raw_with_data``,
``analysis/gradient.py``). The semantics are those of the vmapped nested
``lax.while_loop``s: a lane whose fit has stopped is frozen; a lane whose
line search has ended waits, frozen, while other lanes' searches go on;
each lane keeps its own phase (interval search or zoom) on the device, both
phases' candidate steps are formed and one is picked per lane, so that one
objective evaluation serves every lane's line-search step; the loop ends
when every lane has stopped. So each lane's ``x``, ``fun`` and ``nit`` are
those of its solo fit (the evaluation counts are not: every evaluation
covers all lanes). The host reads one small flag tensor per evaluation:
whether any lane's line search goes on, whether any lane's fit goes on, and
whether any lane must be evaluated again.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE
from pisa_tpu_torch.core.container import resolve_device

__all__ = ["lbfgs_while", "minimize_on_device", "fit_batch_on_device",
           "fit_pseudo_ensemble", "DEFAULT_GTOL"]

_EPS = 1e-6  # sigmoid clip for the initial logit transform

# Default gradient-norm stopping tolerance (pisa_tpu/analysis/device_fit.py:
# 48): at float32 the objective's gradient noise floor sits around 1e-4, so
# insisting on 1e-6 just burns the whole max_steps budget after convergence.
DEFAULT_GTOL = 1e-6 if FTYPE == np.float64 else 3e-4

# optax.scale_by_zoom_linesearch's defaults, as optax.lbfgs() sets them
_MAX_LINESEARCH_STEPS = 20
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
_TOL = 0.0


def _to_z(x, device, dtype=TORCH_FTYPE):
    if isinstance(x, torch.Tensor):
        x = x.to(device, torch.float64)
    else:
        x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
    x = torch.clamp(x.to(dtype), _EPS, 1.0 - _EPS)
    return torch.log(x) - torch.log1p(-x)


def _guard(value):
    """Replace a non-finite objective value so that the line search
    backtracks instead of stalling (``device_fit.py:60-69``)."""
    return torch.where(torch.isfinite(value), value,
                       torch.full_like(value, 1e30))


def _vdot(a, b):
    return (a * b).sum(-1)


def _where(mask, new, old):
    """`new` where the lane mask holds, else `old`; the mask (B,) spreads
    over the trailing axes of (B, ...) values."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim()
                                                         - mask.dim())),
                       new, old)


def _select(mask, new, old):
    """Two line-search states merged lane by lane (the host's step count
    is the same in both)."""
    return {k: _where(mask, v, old[k]) if isinstance(v, torch.Tensor) else v
            for k, v in new.items()}


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (``linesearch.py:455``); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch.py:496``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _LineSearch:
    """optax's zoom line search (``linesearch.py:576-1330``) as torch ops.

    The state is a dict of tensors on the device, one value per lane
    (0-d for a single fit). A step's phase (interval search or zoom) is
    either the host's (a single fit: the ``interval_found`` flag it read
    after the previous step) or each lane's own, on the device (a batched
    fit); everything else is decided on the device."""

    def __init__(self, value_and_grad):
        self.value_and_grad = value_and_grad

    @staticmethod
    def init(params, updates, value, grad):
        dtype, device = params.dtype, params.device

        def scalar(x):
            return torch.full(value.shape, x, dtype=dtype, device=device)

        slope = _vdot(updates, grad)
        inf = scalar(float("inf"))
        false = torch.zeros(value.shape, dtype=torch.bool, device=device)
        zero = scalar(0.0)
        return dict(
            count=0, params=params, updates=updates,
            stepsize_guess=scalar(1.0),
            stepsize=zero, value=value, grad=grad, slope=slope,
            value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf, error=inf,
            interval_found=false, done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad,
        )

    def _value_and_slope_on_line(self, s, stepsize):
        step = s["params"] + stepsize[..., None] * s["updates"]
        value, grad = self.value_and_grad(step)
        return value, grad, _vdot(grad, s["updates"])

    @staticmethod
    def _decrease_error(stepsize, value_step, slope_step, value_init,
                        slope_init):
        decrease_error = (value_step - value_init
                          - _SLOPE_RTOL * stepsize * slope_init)
        approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
        delta_values = (value_step - value_init
                        - _APPROX_DEC_RTOL * torch.abs(value_init))
        approx = torch.maximum(approx, delta_values)
        decrease_error = torch.minimum(approx, decrease_error)
        decrease_error = torch.clamp_min(decrease_error, 0.0)
        return torch.where(torch.isnan(decrease_error),
                      torch.full_like(decrease_error, float("inf")),
                      decrease_error)

    @staticmethod
    def _curvature_error(slope_step, slope_init):
        curvature_error = torch.abs(slope_step) - _CURV_RTOL * torch.abs(
            slope_init)
        curvature_error = torch.clamp_min(curvature_error, 0.0)
        return torch.where(torch.isnan(curvature_error),
                      torch.full_like(curvature_error, float("inf")),
                      curvature_error)

    @staticmethod
    def _search_stepsize(s):
        """The interval search's trial step (``linesearch.py:826``)."""
        if s["count"] == 0:
            return s["stepsize_guess"]
        return _INCREASE_FACTOR * s["stepsize"]

    def _search_interval(self, s, new_stepsize, value, grad, slope):
        """Algorithm 3.5 of Nocedal and Wright (``linesearch.py:826``), at
        its trial step and the objective there."""
        iter_num = s["count"]
        prev_stepsize, prev_value, prev_slope = (
            s["stepsize"], s["value"], s["slope"])
        decrease_error = self._decrease_error(
            new_stepsize, value, slope, s["value_init"], s["slope_init"])
        curvature_error = self._curvature_error(slope, s["slope_init"])
        new_error = torch.maximum(decrease_error, curvature_error)

        safe_decrease = decrease_error <= _TOL
        set_high_to_new = decrease_error > 0.0
        if iter_num > 0:
            set_high_to_new = set_high_to_new | (value >= prev_value)
        set_low_to_new = (slope >= 0.0) & ~set_high_to_new
        low = torch.where(set_low_to_new, new_stepsize, prev_stepsize)
        value_low = torch.where(set_low_to_new, value, prev_value)
        slope_low = torch.where(set_low_to_new, slope, prev_slope)
        high = torch.where(set_low_to_new, prev_stepsize, new_stepsize)
        value_high = torch.where(set_low_to_new, prev_value, value)
        slope_high = torch.where(set_low_to_new, prev_slope, slope)
        interval_found = set_high_to_new | set_low_to_new | (new_error <= _TOL)
        # no maximal stepsize: done only when both criteria hold
        done = new_error <= _TOL
        failed = (iter_num + 1 >= _MAX_LINESEARCH_STEPS) & ~done
        return dict(
            s, count=iter_num + 1,
            stepsize=new_stepsize, value=value, grad=grad, slope=slope,
            decrease_error=decrease_error, curvature_error=curvature_error,
            error=new_error,
            interval_found=interval_found, done=done, failed=failed,
            low=low, value_low=value_low, slope_low=slope_low,
            high=high, value_high=value_high, slope_high=slope_high,
            cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=_where(safe_decrease, new_stepsize,
                                 s["safe_stepsize"]),
            safe_value=_where(safe_decrease, value, s["safe_value"]),
            safe_grad=_where(safe_decrease, grad, s["safe_grad"]),
        )

    @staticmethod
    def _zoom_stepsize(s):
        """The zoom's trial step: cubic, quadratic or bisection
        (``linesearch.py:979``)."""
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high = s["high"], s["value_high"]
        cubic_ref, value_cubic_ref = s["cubic_ref"], s["value_cubic_ref"]

        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta

        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 cubic_ref, value_cubic_ref)
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = ~use_cubic & ((middle_quad > left + quad_chk)
                                 & (middle_quad < right - quad_chk))
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        return torch.where(use_bisection, (low + high) / 2.0, middle)

    def _zoom_into_interval(self, s, middle, value, grad, slope):
        """Algorithm 3.6 of Nocedal and Wright (``linesearch.py:979``), at
        its trial step and the objective there."""
        iter_num = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (
            s["high"], s["value_high"], s["slope_high"])
        too_small_int = torch.abs(high - low) <= _INTERVAL_THRESHOLD

        decrease_error = self._decrease_error(
            middle, value, slope, s["value_init"], s["slope_init"])
        curvature_error = self._curvature_error(slope, s["slope_init"])
        new_error = torch.maximum(decrease_error, curvature_error)

        safe_decrease = decrease_error <= _TOL
        update_safe = safe_decrease & (value < s["safe_value"])
        safe_stepsize = torch.where(update_safe, middle, s["safe_stepsize"])
        done = new_error <= _TOL

        set_high_to_middle = (decrease_error > 0.0) | (value >= value_low)
        secant_interval = slope * (high - low)
        set_high_to_low = (secant_interval >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle

        new_high = torch.where(set_high_to_middle, middle, high)
        new_value_high = torch.where(set_high_to_middle, value, value_high)
        new_slope_high = torch.where(set_high_to_middle, slope, slope_high)
        new_high = torch.where(set_high_to_low, low, new_high)
        new_value_high = torch.where(set_high_to_low, value_low, new_value_high)
        new_slope_high = torch.where(set_high_to_low, slope_low, new_slope_high)
        new_low = torch.where(set_low_to_middle, middle, low)
        new_value_low = torch.where(set_low_to_middle, value, value_low)
        new_slope_low = torch.where(set_low_to_middle, slope, slope_low)
        high_moved = set_high_to_middle | set_high_to_low
        new_cubic_ref = torch.where(high_moved, high, low)
        new_value_cubic_ref = torch.where(high_moved, value_high, value_low)

        presumably_failed = too_small_int & (safe_stepsize > 0.0)
        if iter_num + 1 >= _MAX_LINESEARCH_STEPS:
            presumably_failed = torch.ones_like(presumably_failed)
        failed = presumably_failed & ~done
        return dict(
            s, count=iter_num + 1,
            stepsize=middle, value=value, grad=grad, slope=slope,
            decrease_error=decrease_error, curvature_error=curvature_error,
            error=new_error, done=done, failed=failed,
            low=new_low, value_low=new_value_low, slope_low=new_slope_low,
            high=new_high, value_high=new_value_high,
            slope_high=new_slope_high,
            cubic_ref=new_cubic_ref, value_cubic_ref=new_value_cubic_ref,
            safe_stepsize=safe_stepsize,
            safe_value=torch.where(update_safe, value, s["safe_value"]),
            safe_grad=_where(update_safe, grad, s["safe_grad"]),
        )

    def step(self, s, zoom, active=None):
        """One line-search step (``linesearch.py:1201``); a failed step
        falls back to the safe stepsize (``_try_safe_step``).

        `zoom` is the phase: a Python bool (the host's copy of
        ``s["interval_found"]``: one phase for all) or a lane mask on the
        device. With a mask both phases' trial steps are formed, each lane
        evaluates its own in the one objective evaluation, and each lane
        takes its phase's update. `active` (a lane mask) puts the lanes
        whose line search has ended at their own point, step 0."""
        if isinstance(zoom, bool):
            trial = (self._zoom_stepsize(s) if zoom
                     else self._search_stepsize(s))
            value, grad, slope = self._value_and_slope_on_line(s, trial)
            s = (self._zoom_into_interval if zoom else self._search_interval)(
                s, trial, value, grad, slope)
        else:
            search, middle = self._search_stepsize(s), self._zoom_stepsize(s)
            trial = torch.where(zoom, middle, search)
            if active is not None:
                trial = torch.where(active, trial, torch.zeros_like(trial))
            value, grad, slope = self._value_and_slope_on_line(s, trial)
            s = _select(zoom,
                        self._zoom_into_interval(s, middle, value, grad,
                                                 slope),
                        self._search_interval(s, search, value, grad, slope))
        use_safe = s["failed"] & ((s["safe_stepsize"] > 0.0)
                                  | torch.isinf(s["decrease_error"]))
        return dict(
            s,
            stepsize=torch.where(use_safe, s["safe_stepsize"], s["stepsize"]),
            value=torch.where(use_safe, s["safe_value"], s["value"]),
            grad=_where(use_safe, s["safe_grad"], s["grad"]),
        )


def _precondition(updates, dws, dus, rhos, identity_scale, memory_idx):
    """The L-BFGS two-loop recursion (``transform.py:1497``) over the
    memory slots in optax's order."""
    memory_size = rhos.shape[-1]
    indices = [(memory_idx + j) % memory_size for j in range(memory_size)]
    vec = updates
    alphas = {}
    for idx in reversed(indices):
        alphas[idx] = rhos[..., idx] * _vdot(dws[..., idx, :], vec)
        vec = vec + (-alphas[idx])[..., None] * dus[..., idx, :]
    vec = identity_scale[..., None] * vec
    for idx in indices:
        beta = rhos[..., idx] * _vdot(dus[..., idx, :], vec)
        vec = vec + (alphas[idx] - beta)[..., None] * dws[..., idx, :]
    return vec


class _Memory:
    """optax's ScaleByLBFGSState: the last point and gradient and the s/y
    history, one per lane (``transform.py:1497-1600``)."""

    def __init__(self, z, memory_size):
        n = z.shape[-1]
        self.size = memory_size
        self.prev_params = torch.zeros_like(z)
        self.prev_updates = torch.zeros_like(z)
        self.dws = torch.zeros(z.shape[:-1] + (memory_size, n),
                               dtype=z.dtype, device=z.device)
        self.dus = torch.zeros_like(self.dws)
        self.rhos = torch.zeros(z.shape[:-1] + (memory_size,),
                                dtype=z.dtype, device=z.device)

    def direction(self, z, grad, count):
        """scale_by_lbfgs at optax's iteration `count`: the memory, then the
        preconditioned direction."""
        memory_idx = count % self.size
        prev_idx = (count - 1) % self.size
        if count > 0:
            diff_params = z - self.prev_params
            diff_updates = grad - self.prev_updates
            vdot = _vdot(diff_updates, diff_params)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot),
                                 1.0 / vdot)
            denominator = _vdot(diff_updates, diff_updates)
            identity_scale = torch.where(denominator > 0.0,
                                         vdot / denominator,
                                         torch.ones_like(denominator))
        else:
            diff_params = diff_updates = torch.zeros_like(z)
            weight = torch.zeros(z.shape[:-1], dtype=z.dtype,
                                 device=z.device)
            identity_scale = torch.clamp_max(
                1.0 / torch.sqrt((grad * grad).sum(-1)), 1.0)
        self.dws[..., prev_idx, :] = diff_params
        self.dus[..., prev_idx, :] = diff_updates
        self.rhos[..., prev_idx] = weight
        direction = _precondition(grad, self.dws, self.dus, self.rhos,
                                  identity_scale, memory_idx)
        self.prev_params, self.prev_updates = z, grad
        return direction


def lbfgs_while(fun, z0, max_steps=200, gtol=None, memory_size=10):
    """Minimize ``fun(z) -> 0-d tensor`` (differentiable in z) from `z0` as
    ``optax.lbfgs(memory_size=memory_size)`` does, driven as the JAX
    package's ``lbfgs_while`` drives it: iterate while ``count == 0`` or
    (``count < max_steps`` and ``||grad||_2 >= gtol``).

    With a (B, n) `z0`, B independent fits run as lanes of one loop, as
    under ``jax.vmap`` (module docstring): ``fun`` then maps (B, n) to (B,)
    values, lane b depending on row b only.

    The value is guarded (non-finite -> 1e30) as in the reference. Returns
    ``(z, value, nit, nfev, reads)``: the final z and value (tensors on
    z0's device), optax's iteration ``count`` (an int; with lanes a (B,)
    int64 tensor, each lane's own), the number of objective evaluations,
    and the number of host reads of the loop's flags (one per evaluation
    after the first)."""
    if gtol is None:
        gtol = DEFAULT_GTOL
    z = z0.detach()
    dtype, device = z.dtype, z.device
    nfev = 0

    def value_and_grad(point):
        nonlocal nfev
        nfev += 1
        point = point.detach().requires_grad_(True)
        with torch.enable_grad():
            value = _guard(fun(point))
            (grad,) = torch.autograd.grad(value, point,
                                          torch.ones_like(value))
        return value.detach().to(dtype), grad.to(dtype)

    gtol_t = torch.full((), float(gtol), dtype=dtype, device=device)
    run = _lbfgs_lanes if z.dim() == 2 else _lbfgs_single
    z, value, nit, reads = run(_LineSearch(value_and_grad), z, max_steps,
                               gtol_t, memory_size)
    return z, value, nit, nfev, reads


def _lbfgs_single(line_search, z, max_steps, gtol_t, memory_size):
    """One fit; the host branches where optax's loops do. It is kept beside
    :func:`_lbfgs_lanes`, whose one lane gives the same fit: there each
    line-search step forms and merges both phases' updates and the state
    of lanes that are done, which cost the flagship's ``device`` fit 1.5-1.9
    ms more per evaluation on an H100 (``scripts/time_device_fit.py``;
    PERF.md)."""
    memory = _Memory(z, memory_size)
    count = 0
    value = grad = None
    need_eval = True
    reads = 0
    while True:
        if need_eval:  # optax.value_and_grad_from_state
            value, grad = line_search.value_and_grad(z)
        updates = -1.0 * memory.direction(z, grad, count)
        count += 1

        # scale_by_zoom_linesearch: one objective evaluation a step; after
        # each, one read of (goes on, zooms, fit goes on, re-evaluate)
        s = _LineSearch.init(z, updates, value, grad)
        zoom = False
        while True:
            s = line_search.step(s, zoom)
            ls_on = ~(s["done"] | s["failed"])
            z_next = z + s["stepsize"] * updates
            keep_going = (count < max_steps) & (
                torch.sqrt((s["grad"] * s["grad"]).sum(-1)) >= gtol_t)
            flags = torch.stack([ls_on, s["interval_found"], keep_going,
                                 ~torch.isfinite(s["value"])])
            ls_on, zoom, keep_going, need_eval = flags.tolist()
            reads += 1
            if not ls_on:
                break
        z, value, grad = z_next, s["value"], s["grad"]
        if not keep_going:
            return z, value, count, reads


def _lbfgs_lanes(line_search, z, max_steps, gtol_t, memory_size):
    """B fits as lanes of one loop (module docstring). Every lane still
    fitting has run the same number of iterations and, within one, of
    line-search steps, so the iteration and step counts are the host's;
    what differs between lanes (the phase, whether the search or the fit
    goes on) is a mask on the device."""
    memory = _Memory(z, memory_size)
    fit_on = torch.ones(z.shape[:-1], dtype=torch.bool, device=z.device)
    nit = torch.zeros(z.shape[:-1], dtype=torch.int64, device=z.device)
    value, grad = line_search.value_and_grad(z)
    count = 0
    reads = 0
    while True:
        # a stopped lane moves no more: zero updates keep it at its point
        updates = _where(fit_on, -1.0 * memory.direction(z, grad, count),
                         torch.zeros_like(z))
        count += 1
        s = _LineSearch.init(z, updates, value, grad)
        ls_on = fit_on
        while True:
            s = _select(ls_on, line_search.step(s, s["interval_found"],
                                                active=ls_on), s)
            ls_on = ls_on & ~(s["done"] | s["failed"])
            keep = (count < max_steps) & (
                torch.sqrt((s["grad"] * s["grad"]).sum(-1)) >= gtol_t)
            flags = torch.stack([ls_on.any(), (fit_on & keep).any(),
                                 (fit_on & keep
                                  & ~torch.isfinite(s["value"])).any()])
            any_ls, any_on, any_eval = flags.tolist()
            reads += 1
            if not any_ls:
                break
        z = _where(fit_on, z + s["stepsize"][..., None] * updates, z)
        value = torch.where(fit_on, s["value"], value)
        grad = _where(fit_on, s["grad"], grad)
        nit = torch.where(fit_on, torch.full_like(nit, count), nit)
        fit_on = fit_on & keep
        if not any_on:
            return z, value, nit, reads
        if any_eval:  # optax.value_and_grad_from_state, lane by lane
            again = fit_on & ~torch.isfinite(value)
            value_again, grad_again = line_search.value_and_grad(z)
            value = torch.where(again, value_again, value)
            grad = _where(again, grad_again, grad)


def minimize_on_device(raw_objective, x0, los, his, max_steps=200, gtol=None,
                       device="cuda"):
    """One complete bounded fit (``pisa_tpu/analysis/device_fit.py:107``).

    Parameters
    ----------
    raw_objective : callable
        ``(vec, los, his) -> scalar tensor`` (always minimized),
        differentiable in `vec`, e.g. ``value_fn.raw`` from
        :meth:`CompiledTemplate.build_objective` or
        :meth:`CompiledDistribution.build_objective`.
    x0 : array (n_free,)
        Start point in the [0, 1] rescaled space.
    los, his : arrays (n_free,)
        The current physical bounds, passed through to the objective as
        float64 tensors on `device`.
    max_steps : int
        Most L-BFGS iterations.
    gtol : float
        Stop when the gradient's L2 norm (in z) falls below it.
    device : torch.device or str
        Where the fit state lives and the objective is evaluated. A CUDA
        device without a card raises, and so does an objective whose
        ``device`` attribute names another device: the JAX package's
        ``platform="cpu"`` routing has no counterpart here, a fit on the
        CPU is a fit of an objective built on the CPU
        (``DistributionMaker(..., device="cpu")``).

    Returns
    -------
    dict with ``x`` ([0, 1] space, numpy), ``fun``, ``nit`` (optax's
    iteration count), ``nfev`` (objective evaluations) and ``reads`` (host
    reads of the loop's flags); host values.
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

    def fun(z):
        return raw_objective(torch.sigmoid(z), los, his)

    z, value, nit, nfev, reads = lbfgs_while(
        fun, _to_z(x0, device), max_steps=max_steps, gtol=gtol)
    return {
        "x": torch.sigmoid(z).cpu().numpy().astype(np.float64),
        "fun": float(value),
        "nit": int(nit),
        "nfev": int(nfev),
        "reads": int(reads),
    }


def _fit_lanes(raw_with_data, x0_batch, los, his, data_batch, max_steps,
               gtol, device):
    """The batched fit behind :func:`fit_batch_on_device`, with its
    evaluation and flag-read counts."""
    if gtol is None:
        gtol = DEFAULT_GTOL
    device = resolve_device(device)
    objective_device = getattr(raw_with_data, "device", None)
    if objective_device is not None and (
            resolve_device(objective_device) != device):
        raise ValueError(f"the objective lives on {objective_device}, the fit"
                         f" was asked for on {device}")
    los, his = (torch.as_tensor(np.asarray(b, dtype=np.float64), device=device)
                for b in (los, his))
    z0 = _to_z(x0_batch, device)
    if z0.dim() != 2:
        raise ValueError(f"x0_batch must be (B, n_free); got {tuple(z0.shape)}")
    data = None
    if data_batch is not None:
        data = (data_batch if isinstance(data_batch, torch.Tensor)
                else torch.as_tensor(np.asarray(data_batch)))
        data = data.to(device, TORCH_FTYPE).reshape(z0.shape[0], -1)
        data = data.contiguous()

    # the data batch is loaded into the objective once, for the whole fit
    bind = getattr(raw_with_data, "bind", None)
    if bind is not None:
        raw = bind(data, z0.shape[0])
    else:
        def raw(vec, los, his):
            return raw_with_data(vec, los, his, data)

    def fun(z):
        return raw(torch.sigmoid(z), los, his)

    z, value, nit, nfev, reads = lbfgs_while(fun, z0, max_steps=max_steps,
                                             gtol=gtol)
    return {"x": torch.sigmoid(z), "fun": value, "nit": nit, "nfev": nfev,
            "reads": reads}


def fit_batch_on_device(raw_with_data, x0_batch, los, his, data_batch,
                        max_steps=100, gtol=None, device="cuda"):
    """B independent bounded fits in one loop (the counterpart of
    ``pisa_tpu/analysis/device_fit.py:192``, its vmapped L-BFGS).

    Parameters
    ----------
    raw_with_data : callable
        The batched objective ``(vec (B, n), los, his, data (B, bins) or
        None) -> (B,)``, e.g. ``value_fn.raw_with_data`` of
        :meth:`CompiledDistribution.build_objective`.
    x0_batch : array or tensor (B, n_free)
        Each lane's start in the [0, 1] rescaled space.
    los, his : arrays (n_free,)
        The physical bounds, shared by the lanes.
    data_batch : array or tensor (B, n_bins), or None
        Each lane's data (pseudo-experiments); None fits every lane to the
        objective's own data (multi-start).
    max_steps, gtol : the stopping rule of :func:`lbfgs_while`.
    device : where the fits live; the objective's device (no CPU routing).

    Returns
    -------
    (x_batch (B, n_free) in [0, 1], fun_batch (B,), nit_batch (B,) int64):
    tensors on `device`; each lane's are those of its solo fit.
    """
    fit = _fit_lanes(raw_with_data, x0_batch, los, his, data_batch,
                     max_steps, gtol, device)
    return fit["x"], fit["fun"], fit["nit"]


def fit_pseudo_ensemble(compiled_dist, metric, n_trials, seed=0,
                        max_steps=100, gtol=None, x0=None):
    """Poisson pseudo-experiments of the current expectation (the Asimov
    template) of `compiled_dist`, drawn and fit on its device
    (``pisa_tpu/analysis/device_fit.py:238``; reference ``Map.fluctuate``,
    ``pisa/core/map.py:1118``, then a fit per trial): all `n_trials` fits
    run as lanes of one batched fit (:func:`fit_batch_on_device`).

    The draws come from ``torch.poisson`` with a ``torch.Generator`` on the
    objective's device seeded from `seed`: the same seed gives the same
    data on the same device, not the JAX package's draws.

    Returns
    -------
    dict with ``x`` (n_trials, n_free) best-fit rescaled values,
    ``magnitudes`` (n_trials, n_free) in physical units, ``fun``
    (n_trials,), ``nit`` (n_trials,), ``data`` (n_trials, n_bins) and
    ``free_names``, as host arrays, and ``nfev`` and ``reads``, the batched
    fit's objective evaluations and flag reads.
    """
    cd = compiled_dist
    x_nom = cd.current_rescaled_values()
    los, his = cd._current_bounds()
    asimov = cd.sum_hist(x_nom)
    value_fn, _ = cd.build_objective(asimov, metric)
    device = cd.device

    lam = torch.as_tensor(np.clip(asimov.ravel(), 0.0, None),
                          dtype=TORCH_FTYPE, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    data_batch = torch.poisson(lam.expand(int(n_trials), -1).contiguous(),
                               generator=generator)
    if x0 is None:
        x0 = x_nom
    x0_batch = np.tile(np.asarray(x0, dtype=np.float64), (int(n_trials), 1))
    fit = _fit_lanes(value_fn.raw_with_data, x0_batch, los, his, data_batch,
                     max_steps, gtol, device)
    xb = fit["x"].cpu().numpy().astype(np.float64)

    # physical magnitudes (log-aware, as Param._rescaled_value)
    mags = np.empty_like(xb)
    for i, p in enumerate(cd._free_params):
        lo, hi = los[i], his[i]
        if p.scales_as_log:
            mags[:, i] = lo * np.exp(
                xb[:, i] * (np.log(abs(hi)) - np.log(abs(lo))))
        else:
            mags[:, i] = lo + (hi - lo) * xb[:, i]
    return {
        "x": xb,
        "magnitudes": mags,
        "fun": fit["fun"].cpu().numpy().astype(np.float64),
        "nit": fit["nit"].cpu().numpy(),
        "data": data_batch.cpu().numpy(),
        "free_names": list(cd.free_names),
        "nfev": fit["nfev"],
        "reads": fit["reads"],
    }
