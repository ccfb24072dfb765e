"""
The port's L-BFGS (``pisa_tpu_torch.analysis.device_fit.lbfgs_while`` and
``minimize_on_device``) against the JAX package's (optax L-BFGS with its
zoom line search inside ``lax.while_loop``, ``pisa_tpu/analysis/
device_fit.py``), in fp64 on the CPU: the same start, the same objective,
the same iterations.

- Closed-form objectives in the [0, 1] box: a quadratic, 2-D and 5-D
  Rosenbrock functions (shifted by 1, so that relative values mean
  something at the minimum), and functions that hit the non-finite guard:
  ``nit`` equal, ``x`` within 1e-10, ``fun`` within 1e-12 relative.
- The flagship Asimov fit (20x20 oscillation grid, all 240k events, 15
  free parameters) from theta23 + 0.10 rescaled, 20 iterations: ``nit``
  equal, ``x`` within 1e-6 rescaled, ``fun`` within 1e-9 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis import device_fit as jax_device_fit
from pisa_tpu.config.parser import parse_pipeline_config as jax_parse
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis import device_fit
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.utils.interop import (
    template_inputs_from_jax,
    to_template_order,
)
from test_torch_pipeline import _small_grid_config


def _rosenbrock(xp):
    def fn(x, los=None, his=None, datas=None):
        y = 3.0 * x - 1.0  # the minimum (1, ..., 1) at x = 2/3
        total = 1.0
        for i in range(y.shape[0] - 1):
            total = total + 100.0 * (y[i + 1] - y[i] ** 2) ** 2 + (
                1.0 - y[i]) ** 2
        return total
    return fn


def _quadratic(xp):
    def fn(x, los=None, his=None, datas=None):
        target = xp.asarray([0.3, 0.7]) if xp is jnp else torch.tensor(
            [0.3, 0.7], dtype=x.dtype)
        return ((x - target) ** 2).sum() + 1.5
    return fn


def _nan_beyond(xp):
    """NaN for x[0] > 0.9: the guard turns it into 1e30."""
    def fn(x, los=None, his=None, datas=None):
        value = ((x - 0.5) ** 2).sum() + 1.0
        if xp is jnp:
            return jnp.where(x[0] > 0.9, jnp.nan, value)
        return torch.where(x[0] > 0.9, torch.full_like(value, float("nan")),
                           value)
    return fn


CASES = {
    "quadratic": (_quadratic, [0.9, 0.1]),
    "rosenbrock_2d": (_rosenbrock, [0.1, 0.8]),
    "rosenbrock_5d": (_rosenbrock, [0.1, 0.8, 0.3, 0.6, 0.2]),
    "guard_in_the_line_search": (_nan_beyond, [0.2, 0.4]),
    "guard_at_the_start": (_nan_beyond, [0.95, 0.4]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_minimize_matches_optax(case):
    make, x0 = CASES[case]
    n = len(x0)
    want = jax_device_fit.minimize_on_device(
        make(jnp), x0, np.zeros(n), np.ones(n), None)
    got = device_fit.minimize_on_device(
        make(torch), x0, np.zeros(n), np.ones(n), device="cpu")
    assert got["nit"] == want["nit"] > 0
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["fun"], want["fun"], rtol=1e-12)
    # one read of the loop's flags per evaluation after the first
    assert got["reads"] == got["nfev"] - 1 >= got["nit"]


@pytest.mark.parametrize("max_steps,gtol", [(7, None), (200, 1e-3)])
def test_stopping_rule_matches_optax(max_steps, gtol):
    """The reference's keep_going: count < max_steps and the gradient's L2
    norm >= gtol; the iteration cap and the tolerance are arguments."""
    make, x0 = CASES["rosenbrock_5d"]
    n = len(x0)
    want = jax_device_fit.minimize_on_device(
        make(jnp), x0, np.zeros(n), np.ones(n), None, max_steps=max_steps,
        gtol=gtol)
    got = device_fit.minimize_on_device(
        make(torch), x0, np.zeros(n), np.ones(n), max_steps=max_steps,
        gtol=gtol, device="cpu")
    assert got["nit"] == want["nit"]
    assert got["nit"] == max_steps if gtol is None else got["nit"] < max_steps
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-10)


def test_lbfgs_while_keeps_its_state_where_z_lies():
    """lbfgs_while on tensors: the result lies on z0's device, in z0's
    dtype, and nit is optax's count."""
    calls = []

    def fun(z):
        calls.append(z.device)
        return ((torch.sigmoid(z) - 0.3) ** 2).sum()

    z0 = torch.zeros(3, dtype=torch.float64)
    z, value, nit, nfev, reads = device_fit.lbfgs_while(fun, z0)
    assert z.dtype == value.dtype == torch.float64
    assert z.device == value.device == z0.device
    assert nfev == len(calls) and reads == nfev - 1 and 0 < nit <= nfev
    np.testing.assert_allclose(torch.sigmoid(z).numpy(), 0.3, atol=1e-6)


@pytest.fixture(scope="module")
def flagship_fits():
    """The flagship Asimov fit in both packages, 20 iterations, from theta23
    + 0.10 rescaled (bench.py:411-414)."""
    jax_ct = JaxPipeline(
        _small_grid_config(jax_parse, jax_binning, jax_ureg)).compile()
    v0 = np.asarray(jax_ct.current_rescaled_values())
    data = {m.name: np.asarray(m.hist) for m in jax_ct.get_outputs(v0)}
    jax_value_fn, _ = jax_ct.build_objective(data, "mod_chi2")
    i = jax_ct.free_names.index("theta23")
    x0 = v0.copy()
    x0[i] = min(0.95, x0[i] + 0.10)
    los, his = jax_ct._current_bounds()
    want = jax_device_fit.minimize_on_device(
        jax_value_fn.raw, x0, los, his, jax_ct._data_vals, max_steps=20)

    ct = Pipeline(_small_grid_config(parse_pipeline_config, binning, ureg),
                  device="cpu").compile()
    value_fn, _ = ct.build_objective(data, "mod_chi2")
    got = device_fit.minimize_on_device(
        value_fn.raw, *template_inputs_from_jax(ct, jax_ct.free_names, x0,
                                                los, his),
        max_steps=20, device="cpu")
    return want, got, to_template_order(ct, jax_ct.free_names, want["x"])


def test_flagship_fit_matches_optax(flagship_fits):
    want, got, want_x = flagship_fits
    assert got["nit"] == want["nit"] == 20
    np.testing.assert_allclose(got["x"], want_x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["fun"], want["fun"], rtol=1e-9)
    assert got["reads"] == got["nfev"] - 1
