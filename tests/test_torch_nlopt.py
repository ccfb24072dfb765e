"""
The port's 'nlopt' fit method (``analysis/analysis.py:_fit_nlopt``,
``_fit_nlopt_real``, ``_define_nlopt_opt``) and its scipy-backed nlopt
shim (``utils/nlopt_shim.py``) against the JAX package's, mirroring
tests/test_analysis.py's ``TestNloptShimUnit``, ``TestNloptEquivalent``,
``TestNloptReal`` and ``TestNloptGlobalEquivalents`` on
``settings/pipeline/toy_fit_example.cfg`` in fp64 on the CPU (conftest):
the same Asimov data (theta23 = 42 deg), the same start (40 deg).

The derivative-free algorithms evaluate the eager template, whose values
the two packages share to ~1e-13, so a fit takes the same path in both:
its best fit lies within 1e-6 rescaled of the JAX package's (and within
0.5 deg of the truth, as the JAX package's tests ask), and its evaluation
count equals the JAX package's (within 15% for COBYLA, BOBYQA and AUGLAG
over COBYLA, whose stopping tests near the minimum may end one package's
fit a few evaluations later). The gradient names run the native scipy fits on the
analytic gradient. Neither side has the real nlopt package, so both run
their shims.
"""

import numpy as np
import pytest

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.analysis.analysis import BasicAnalysis as JaxAnalysis
from pisa_tpu.core.distribution_maker import (
    DistributionMaker as JaxDistributionMaker,
)
from pisa_tpu.utils import nlopt_shim as jax_nl
from pisa_tpu_torch import ureg
from pisa_tpu_torch.analysis.analysis import BasicAnalysis, _import_nlopt
from pisa_tpu_torch.core.distribution_maker import DistributionMaker
from pisa_tpu_torch.utils import nlopt_shim as nl

CFG = "settings/pipeline/toy_fit_example.cfg"
TRUTH = 42.0  # theta23, degrees
START = 40.0
FIT_X_ATOL = 1e-6  # rescaled


class Side:
    """One package's hypo maker, Asimov data and analysis class."""

    def __init__(self, dm, ureg_, analysis):
        self.dm, self.ureg, self.analysis = dm, ureg_, analysis
        dm.params["theta23"].value = TRUTH * ureg_.degree
        self.data = dm.get_outputs(return_sum=True)
        dm.reset_free()

    def fit(self, method_kwargs, start=START):
        self.dm.reset_free()
        self.dm.params["theta23"].value = start * self.ureg.degree
        return self.analysis().fit_recursively(
            self.data, self.dm, "mod_chi2", None, "nlopt",
            dict(method_kwargs), None)


@pytest.fixture(scope="module")
def sides():
    return (Side(JaxDistributionMaker([CFG], label="toy"), jax_ureg,
                 JaxAnalysis),
            Side(DistributionMaker([CFG], label="toy", device="cpu"), ureg,
                 BasicAnalysis))


def _fit_both(sides, method_kwargs, start=START):
    return [side.fit(method_kwargs, start) for side in sides]


def _x(result):
    return np.asarray(result.params.free._rescaled_values, dtype=np.float64)


def _t23(result):
    return result.params["theta23"].value.m_as("degree")


def _same_fit(jax_result, result, exact=True):
    """The same best fit; the same evaluation count where `exact`, else
    within 15% (COBYLA's and BOBYQA's stopping tests read values that the
    two packages share to ~1e-13, and may end one fit a few evaluations
    later)."""
    meta, want = result.minimizer_metadata, jax_result.minimizer_metadata
    assert meta["method"] == want["method"]
    np.testing.assert_allclose(_x(result), _x(jax_result), rtol=0,
                               atol=FIT_X_ATOL)
    if exact:
        assert meta["nfev"] == want["nfev"]
    else:
        assert abs(meta["nfev"] - want["nfev"]) <= 0.15 * want["nfev"]


# -- the shim ----------------------------------------------------------------
def _rosen():
    calls = []

    def f(x, grad):
        assert grad.size == 0
        calls.append(np.asarray(x).copy())
        return float((1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2)

    return f, calls


def _opt(lib, algorithm, f, **settings):
    opt = lib.opt(getattr(lib, algorithm), 2)
    opt.set_min_objective(f)
    opt.set_lower_bounds(-2.0)
    opt.set_upper_bounds(2.0)
    for name, value in settings.items():
        getattr(opt, f"set_{name}")(value)
    return opt


@pytest.mark.parametrize("settings,code", [
    ({"ftol_abs": 1e-12}, None),
    ({"maxeval": 17}, "MAXEVAL_REACHED"),
    ({"stopval": 1.0}, "STOPVAL_REACHED"),
])
def test_shim_runs_as_the_jax_shim(settings, code):
    """Nelder-Mead on Rosenbrock: convergence, the evaluation cap and the
    stop value; the same points and result as the JAX package's shim."""
    runs = []
    for lib in (nl, jax_nl):
        f, calls = _rosen()
        opt = _opt(lib, "LN_NELDERMEAD", f, **settings)
        x = opt.optimize(np.array([-1.0, 1.5]))
        runs.append((x, calls, opt.last_optimize_result(),
                     opt.last_optimum_value(), opt.get_numevals()))
        assert opt.get_numevals() == len(calls)
        assert "LN_NELDERMEAD" in opt.get_algorithm_name()
    (x, calls, result, value, _), (jx, jcalls, jresult, jvalue, _) = runs
    np.testing.assert_array_equal(x, jx)
    assert len(calls) == len(jcalls) and result == jresult
    assert value == jvalue
    if code is None:
        assert np.allclose(x, [1.0, 1.0], atol=1e-3) and value < 1e-6
        assert result > 0
    else:
        assert result == getattr(nl, code)
    if code == "MAXEVAL_REACHED":
        assert len(calls) == 17
    if code == "STOPVAL_REACHED":
        assert value <= 1.0


def test_shim_constraints():
    """Constraints only where nlopt takes them; COBYLA holds x0 <= 0.5
    (nlopt's convention: fn(x) <= 0 is feasible)."""
    with pytest.raises(nl.invalid_argument):
        nl.opt(nl.LN_NELDERMEAD, 2).add_inequality_constraint(
            lambda x, g: x[0] - 0.5)
    f, _ = _rosen()
    opt = _opt(nl, "LN_COBYLA", f, xtol_rel=1e-10)
    opt.add_inequality_constraint(lambda x, g: x[0] - 0.5)
    x = opt.optimize(np.array([0.0, 0.0]))
    assert x[0] <= 0.5 + 1e-6 and abs(x[0] - 0.5) < 5e-2


def test_shim_srand_determinism():
    f, _ = _rosen()

    def run(lib):
        lib.srand(42)
        opt = _opt(lib, "G_MLSL_LDS", f, maxeval=200)
        local = _opt(lib, "LN_NELDERMEAD", f, maxeval=50, ftol_abs=1e-8)
        opt.set_local_optimizer(local)
        return opt.optimize(np.array([-1.0, 1.5]))

    first = run(nl)
    np.testing.assert_array_equal(first, run(nl))
    np.testing.assert_array_equal(first, run(jax_nl))


def test_import_nlopt_takes_the_shim(monkeypatch):
    monkeypatch.setenv("PISA_TPU_NLOPT_SHIM", "1")
    assert _import_nlopt() is nl


# -- fits ------------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["LN_NELDERMEAD", "LN_SBPLX", "LN_COBYLA",
                                  "LN_BOBYQA"])
def test_derivative_free_fit_matches_jax(sides, algo):
    jax_result, result = _fit_both(
        sides, {"algorithm": algo, "ftol_abs": 1e-9, "maxeval": 500})
    _same_fit(jax_result, result,
              exact=algo in ("LN_NELDERMEAD", "LN_SBPLX"))
    assert abs(_t23(result) - TRUTH) < 0.5
    meta = result.minimizer_metadata
    assert meta["method"].startswith("nlopt:") and meta["nlopt_result"] > 0
    assert meta["message"] == jax_result.minimizer_metadata["message"]
    np.testing.assert_allclose(result.metric_val, jax_result.metric_val,
                               rtol=1e-6, atol=1e-9)


def test_gradient_name_runs_the_native_fit(sides):
    """LD_LBFGS: L-BFGS-B on the analytic gradient, as in the JAX
    package (the same iterations)."""
    jax_result, result = _fit_both(
        sides, {"algorithm": "LD_LBFGS", "ftol_abs": 1e-9, "maxeval": 500})
    meta = result.minimizer_metadata
    assert meta["method"] == "nlopt-equivalent (native, LD_LBFGS -> l-bfgs-b)"
    assert meta["nit"] == jax_result.minimizer_metadata["nit"]
    np.testing.assert_allclose(_x(result), _x(jax_result), rtol=0,
                               atol=FIT_X_ATOL)
    assert abs(_t23(result) - TRUTH) < 0.5


def test_mlsl_with_local_optimizer_matches_jax(sides):
    jax_result, result = _fit_both(sides, {
        "algorithm": "G_MLSL_LDS", "maxeval": 60, "seed": 1,
        "local_optimizer": {"algorithm": "LN_NELDERMEAD", "ftol_abs": 1e-6,
                            "maxeval": 20},
    }, start=43.0)
    assert np.isfinite(result.metric_val)
    _same_fit(jax_result, result)


def test_auglag_inequality_constraint_matches_jax(sides):
    """AUGLAG with theta23 held below 44 deg."""
    jax_result, result = _fit_both(sides, {
        "algorithm": "AUGLAG", "maxeval": 400,
        "ineq_constraints": ["44.0 - params.theta23.value.m_as('degree')"],
        "local_optimizer": {"algorithm": "LN_COBYLA", "ftol_abs": 1e-8,
                            "maxeval": 200},
    })
    assert _t23(result) <= 44.0 + 0.1
    _same_fit(jax_result, result, exact=False)


@pytest.mark.parametrize("algo,kwargs", [
    ("GN_DIRECT", {"maxeval": 25, "ftol_abs": 1e-3}),
    ("GN_CRS2_LM", {"maxeval": 2, "ftol_rel": 1e-2}),
    ("G_MLSL", {"maxeval": 20}),
])
def test_global_algorithms_match_jax(sides, algo, kwargs):
    jax_result, result = _fit_both(sides, {"algorithm": algo, **kwargs},
                                   start=43.0)
    assert np.isfinite(result.metric_val)
    _same_fit(jax_result, result)


def test_unknown_algorithm_raises(sides):
    _, side = sides
    with pytest.raises(ValueError, match="LN_BOGUS"):
        side.fit({"algorithm": "LN_BOGUS"})
    with pytest.raises(ValueError, match="LD_BOGUS"):
        side.fit({"algorithm": "LD_BOGUS"})
