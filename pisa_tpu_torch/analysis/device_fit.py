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
axis, so that a leading batch dimension can be added later. The vmapped
``fit_batch_on_device`` and ``fit_pseudo_ensemble`` are not ported yet
(ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE
from pisa_tpu_torch.core.container import resolve_device

__all__ = ["lbfgs_while", "minimize_on_device", "DEFAULT_GTOL"]

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
    x = torch.clamp(torch.as_tensor(np.asarray(x, dtype=np.float64),
                                    device=device).to(dtype),
                    _EPS, 1.0 - _EPS)
    return torch.log(x) - torch.log1p(-x)


def _guard(value):
    """Replace a non-finite objective value so that the line search
    backtracks instead of stalling (``device_fit.py:60-69``)."""
    return torch.where(torch.isfinite(value), value,
                       torch.full_like(value, 1e30))


def _vdot(a, b):
    return (a * b).sum(-1)


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

    The state is a dict of tensors on the device. The host picks the phase
    (interval search or zoom) from the ``interval_found`` flag it read after
    the previous step; everything else is decided on the device."""

    def __init__(self, value_and_grad):
        self.value_and_grad = value_and_grad

    @staticmethod
    def init(params, updates, value, grad):
        dtype, device = params.dtype, params.device

        def scalar(x):
            return torch.full((), x, dtype=dtype, device=device)

        slope = _vdot(updates, grad)
        inf = scalar(float("inf"))
        false = torch.zeros((), dtype=torch.bool, device=device)
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
        step = s["params"] + stepsize * s["updates"]
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

    def _search_interval(self, s):
        """Algorithm 3.5 of Nocedal and Wright (``linesearch.py:826``)."""
        iter_num = s["count"]
        prev_stepsize, prev_value, prev_slope = (
            s["stepsize"], s["value"], s["slope"])
        new_stepsize = (s["stepsize_guess"] if iter_num == 0
                        else _INCREASE_FACTOR * prev_stepsize)
        value, grad, slope = self._value_and_slope_on_line(s, new_stepsize)
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
            safe_stepsize=torch.where(safe_decrease, new_stepsize,
                                 s["safe_stepsize"]),
            safe_value=torch.where(safe_decrease, value, s["safe_value"]),
            safe_grad=torch.where(safe_decrease, grad, s["safe_grad"]),
        )

    def _zoom_into_interval(self, s):
        """Algorithm 3.6 of Nocedal and Wright (``linesearch.py:979``)."""
        iter_num = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (
            s["high"], s["value_high"], s["slope_high"])
        cubic_ref, value_cubic_ref = s["cubic_ref"], s["value_cubic_ref"]

        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= _INTERVAL_THRESHOLD

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
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)

        value, grad, slope = self._value_and_slope_on_line(s, middle)
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
            safe_grad=torch.where(update_safe, grad, s["safe_grad"]),
        )

    def step(self, s, zoom):
        """One line-search step (``linesearch.py:1201``): the phase `zoom`
        is the host's copy of ``s["interval_found"]``; a failed step falls
        back to the safe stepsize (``_try_safe_step``)."""
        s = self._zoom_into_interval(s) if zoom else self._search_interval(s)
        use_safe = s["failed"] & ((s["safe_stepsize"] > 0.0)
                                  | torch.isinf(s["decrease_error"]))
        return dict(
            s,
            stepsize=torch.where(use_safe, s["safe_stepsize"], s["stepsize"]),
            value=torch.where(use_safe, s["safe_value"], s["value"]),
            grad=torch.where(use_safe, s["safe_grad"], s["grad"]),
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


def lbfgs_while(fun, z0, max_steps=200, gtol=None, memory_size=10):
    """Minimize ``fun(z) -> 0-d tensor`` (differentiable in z) from `z0` as
    ``optax.lbfgs(memory_size=memory_size)`` does, driven as the JAX
    package's ``lbfgs_while`` drives it: iterate while ``count == 0`` or
    (``count < max_steps`` and ``||grad||_2 >= gtol``).

    The value is guarded (non-finite -> 1e30) as in the reference. Returns
    ``(z, value, nit, nfev, reads)``: the final z and value (tensors on
    z0's device), optax's iteration ``count``, the number of objective
    evaluations, and the number of host reads of the loop's flags (one per
    evaluation after the first)."""
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
            (grad,) = torch.autograd.grad(value, point)
        return value.detach().to(dtype), grad.to(dtype)

    line_search = _LineSearch(value_and_grad)
    n = z.shape[-1]
    # optax's ScaleByLBFGSState and ScaleByZoomLinesearchState
    count = 0
    prev_params = torch.zeros_like(z)
    prev_updates = torch.zeros_like(z)
    dws = torch.zeros(z.shape[:-1] + (memory_size, n), dtype=dtype,
                      device=device)
    dus = torch.zeros_like(dws)
    rhos = torch.zeros(z.shape[:-1] + (memory_size,), dtype=dtype,
                       device=device)
    value = grad = None
    need_eval = True
    reads = 0
    gtol_t = torch.full((), float(gtol), dtype=dtype, device=device)
    while True:
        if need_eval:  # optax.value_and_grad_from_state
            value, grad = value_and_grad(z)
        # scale_by_lbfgs: the memory, then the preconditioned direction
        memory_idx = count % memory_size
        prev_idx = (count - 1) % memory_size
        if count > 0:
            diff_params = z - prev_params
            diff_updates = grad - prev_updates
            vdot = _vdot(diff_updates, diff_params)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            denominator = _vdot(diff_updates, diff_updates)
            identity_scale = torch.where(denominator > 0.0, vdot / denominator,
                                    torch.ones_like(denominator))
        else:
            diff_params = diff_updates = torch.zeros_like(z)
            weight = torch.zeros_like(value)
            identity_scale = torch.clamp_max(
                1.0 / torch.sqrt((grad * grad).sum(-1)), 1.0)
        dws[..., prev_idx, :] = diff_params
        dus[..., prev_idx, :] = diff_updates
        rhos[..., prev_idx] = weight
        direction = _precondition(grad, dws, dus, rhos, identity_scale,
                                  memory_idx)
        prev_params, prev_updates = z, grad
        count += 1
        updates = -1.0 * direction

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
            return z, value, count, nfev, reads


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
