"""
The port's bounded fit (``pisa_tpu_torch.analysis.device_fit.
minimize_on_device``): the machinery on closed-form objectives (the patterns
of tests/test_device_fit.py:30-100), and the flagship Asimov fit
(``bench.py:396-430``) on the 20x20-grid flagship with all 240k events on
the CPU in fp64, as ``Pipeline(...).compile().build_objective(...)`` feeds
it.
"""

import numpy as np
import pytest
import torch

from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis import device_fit
from pisa_tpu_torch.config.parser import parse_pipeline_config
from pisa_tpu_torch.core import binning
from pisa_tpu_torch.core.pipeline import Pipeline
from test_torch_pipeline import _small_grid_config


def _quad_raw(vec, los, his):
    # minimum inside the box at x = (0.3, 0.7)
    target = torch.tensor([0.3, 0.7], dtype=vec.dtype)
    return torch.sum((vec - target) ** 2) + 1.5


def test_minimize_quadratic():
    res = device_fit.minimize_on_device(
        _quad_raw, [0.9, 0.1], np.zeros(2), np.ones(2), device="cpu")
    assert np.allclose(res["x"], [0.3, 0.7], atol=1e-4)
    assert res["fun"] == pytest.approx(1.5, abs=1e-8)
    assert 0 < res["nit"] <= 200


def test_minimize_tolerances_are_arguments():
    res = device_fit.minimize_on_device(
        _quad_raw, [0.2, 0.9], np.zeros(2), np.ones(2), max_steps=50,
        gtol=1e-4, device="cpu")
    assert np.allclose(res["x"], [0.3, 0.7], atol=1e-3)
    assert 0 < res["nit"] <= 50


def test_bounds_respected():
    # unconstrained minimum at 1.5 -> the fit must stay inside (0, 1)
    def raw(vec, los, his):
        return torch.sum((vec - 1.5) ** 2)

    res = device_fit.minimize_on_device(raw, [0.5], np.zeros(1), np.ones(1),
                                        max_steps=100, device="cpu")
    assert 0.0 < res["x"][0] <= 1.0
    assert res["x"][0] > 0.95  # pushed to the upper boundary


def test_nonfinite_guard():
    # objective NaN away from the target: the guard must let the fit proceed
    def raw(vec, los, his):
        v = torch.sum((vec - 0.5) ** 2)
        return torch.where(vec[0] > 0.9, torch.full_like(v, float("nan")), v)

    res = device_fit.minimize_on_device(raw, [0.2], np.zeros(1), np.ones(1),
                                        device="cpu")
    assert np.isfinite(res["fun"])
    assert abs(res["x"][0] - 0.5) < 1e-3


def test_objective_sees_the_bounds():
    seen = []

    def raw(vec, los, his):
        seen.append((np.asarray(los), np.asarray(his)))
        return torch.sum((vec - 0.4) ** 2)

    device_fit.minimize_on_device(raw, [0.7], np.full(1, -2.0), np.full(1, 3.0),
                                  device="cpu")
    assert seen and all(lo[0] == -2.0 and hi[0] == 3.0 for lo, hi in seen)


def test_flagship_asimov_fit_recovers_theta23():
    """Asimov data at nominal, start from theta23 + 0.10 rescaled
    (bench.py:411-414): theta23 comes back within 5e-3 rescaled
    (tests/test_device_fit.py:140). 40 L-BFGS steps get there; the CPU run
    takes the one-pass multitangent backward, the cheaper one for the
    plain tangents (both give the same gradient:
    tests/test_torch_template.py)."""
    pipeline = Pipeline(
        _small_grid_config(parse_pipeline_config, binning, ureg),
        device="cpu",
    )
    pipeline["osc.prob3"].multitangent = True
    ct = pipeline.compile()
    v0 = ct.current_rescaled_values()
    value_fn, _ = ct.build_objective(ct.get_outputs(v0), "mod_chi2")
    i = ct.free_names.index("theta23")
    x0 = v0.copy()
    x0[i] = min(0.95, x0[i] + 0.10)
    los, his = ct._current_bounds()
    res = device_fit.minimize_on_device(value_fn.raw, x0, los, his,
                                        max_steps=40, device="cpu")
    assert abs(res["x"][i] - v0[i]) < 5e-3, res
    assert res["fun"] < float(value_fn(x0))
    assert 0 < res["nit"] <= 40


def test_fit_device_is_explicit():
    """The fit runs where the caller says ("cuda" by default): without a
    card that raises, and so does an objective that lives elsewhere.
    Nothing falls back to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_fit.minimize_on_device(_quad_raw, [0.9, 0.1], np.zeros(2),
                                          np.ones(2))

    def raw(vec, los, his):
        return torch.sum(vec ** 2)

    raw.device = torch.device("meta")
    with pytest.raises(ValueError, match="the objective lives on meta"):
        device_fit.minimize_on_device(raw, [0.5], np.zeros(1), np.ones(1),
                                      device="cpu")
    seen = []

    def spy(vec, los, his):
        seen.append((vec.device, los, his))
        return torch.sum((vec - 0.4) ** 2)

    spy.device = "cpu"
    device_fit.minimize_on_device(spy, [0.7], np.zeros(1), np.ones(1),
                                  device="cpu")
    for device, los, his in seen:
        assert device == torch.device("cpu")
        assert isinstance(los, torch.Tensor) and los.dtype == torch.float64
        assert isinstance(his, torch.Tensor) and his.device == device


@pytest.mark.cuda
def test_flagship_asimov_fit_on_the_captured_objective():
    """On the card the fit runs on the captured objective (each evaluation
    a graph replay whose value carries the captured gradient into
    backward()): theta23 comes back within 5e-3 rescaled, as on the eager
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    pipeline = Pipeline(
        _small_grid_config(parse_pipeline_config, binning, ureg),
        device="cuda",
    )
    ct = pipeline.compile()
    v0 = ct.current_rescaled_values()
    asimov = ct.get_outputs(v0)
    i = ct.free_names.index("theta23")
    x0 = v0.copy()
    x0[i] = min(0.95, x0[i] + 0.10)
    los, his = ct._current_bounds()
    results = {}
    for capture in (True, False):
        value_fn, _ = ct.build_objective(asimov, "mod_chi2", capture=capture)
        res = device_fit.minimize_on_device(value_fn.raw, x0, los, his,
                                            max_steps=40)
        assert abs(res["x"][i] - v0[i]) < 5e-3, res
        assert res["fun"] < float(value_fn(x0))
        results[capture] = res
    np.testing.assert_allclose(results[True]["x"], results[False]["x"],
                               atol=1e-6)
