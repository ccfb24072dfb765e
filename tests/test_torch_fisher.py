"""
Forward mode through the port's oscillation boundary (``ops/osc/chain.py:
OscProbs.jvp`` and its vmap rule) and the Fisher-matrix tools built on it
(``analysis/fisher.py``), in fp64 on the CPU (conftest).

- ``OscProbs.jvp`` against its backward (<jvp v, u> = <v, vjp u>, 1e-12)
  and against central differences (steps of 1e-5 of each theta, within
  1e-5 of the column's largest entry); ``torch.func.jacfwd`` (the vmap rule:
  all directions in one multitangent pass) against ``torch.func.jacrev``
  (1e-12), on the flagship's three active parameters and on all six;
- ``jacfwd`` of the stacked flagship template (20x20 grid, rate deferral)
  against central differences of the template;
- ``get_fisher_matrix`` and ``calculate_pulls`` against the JAX package's
  on ``toy_fit_example.cfg`` with ``tiny_grid`` (tests/test_fisher.py's
  set-up) within rtol 1e-8, the JAX package's own checks (the llh
  curvature, an injected shift), ``FisherMatrix``'s operations and a JSON
  round trip through a file the JAX package writes.
"""

import numpy as np
import pytest
import torch

from pisa_tpu.analysis.fisher import FisherMatrix as JaxFisherMatrix
from pisa_tpu.analysis.fisher import calculate_pulls as jax_pulls
from pisa_tpu.analysis.fisher import get_fisher_matrix as jax_fisher
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis.fisher import (
    FisherMatrix,
    _template_jacobian,
    calculate_pulls,
    get_fisher_matrix,
)
from pisa_tpu_torch.core.pipeline import Pipeline
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.resources import find_resource

THETA = [0.5903, 0.1503, 0.8587, 3.4, 7.39e-5, 2.528e-3]
FLAGSHIP_ACTIVE = (1, 2, 5)  # theta13, theta23, dm31


def _geometry(n=160, n_layers=8, seed=7):
    rng = np.random.RandomState(seed)
    e = 10 ** rng.uniform(0, 3, n)
    dens = rng.uniform(1, 12, (n, n_layers))
    dist = rng.uniform(50, 1000, (n, n_layers))
    for i, k in enumerate(rng.randint(0, n_layers + 1, n)):
        dens[i, k:] = 0.0
        dist[i, k:] = 0.0
    return chain.prepare_chain_geometry(e, dens, dist, dtype=torch.float64,
                                        device="cpu")


@pytest.fixture(scope="module")
def geom():
    return _geometry()


def _probs(geom, nubar, active, multitangent=True):
    return lambda t: chain.osc_probs(t, nubar, geom, active=active,
                                     multitangent=multitangent)


@pytest.mark.parametrize("multitangent", [True, False])
@pytest.mark.parametrize("nubar", [1, -1])
def test_jvp_is_the_transpose_of_the_backward(geom, nubar, multitangent):
    """<jvp(v), u> = <v, vjp(u)> for a random direction v and cotangent u;
    the inactive components of v count as zero."""
    rng = np.random.RandomState(3)
    f = _probs(geom, nubar, FLAGSHIP_ACTIVE, multitangent)
    theta = torch.tensor(THETA, dtype=torch.float64)
    v = torch.as_tensor(rng.normal(size=6))
    u = torch.as_tensor(rng.uniform(size=(geom["e"].shape[0], 3, 3)))
    _, jv = torch.func.jvp(f, (theta,), (v,))
    th = theta.clone().requires_grad_(True)
    (f(th) * u).sum().backward()
    np.testing.assert_allclose(float((jv * u).sum()),
                               float((th.grad * v).sum()), rtol=1e-12)
    inactive = v.clone()
    inactive[list(FLAGSHIP_ACTIVE)] = 0.0
    _, zero = torch.func.jvp(f, (theta,), (inactive,))
    assert float(zero.abs().max()) == 0.0


@pytest.mark.parametrize("active", [FLAGSHIP_ACTIVE, tuple(range(6))])
def test_jacfwd_equals_jacrev_and_central_differences(geom, active):
    f = _probs(geom, -1, active)
    theta = torch.tensor(THETA, dtype=torch.float64)
    jac_f = torch.func.jacfwd(f)(theta)
    jac_r = torch.func.jacrev(f)(theta)
    assert jac_f.shape == (geom["e"].shape[0], 3, 3, 6)
    scale = float(jac_r.abs().max())
    assert float((jac_f - jac_r).abs().max()) <= 1e-12 * scale
    for k in range(6):
        if k not in active:
            assert float(jac_f[..., k].abs().max()) == 0.0
            continue
        h = 1e-5 * abs(THETA[k])
        tp, tm = theta.clone(), theta.clone()
        tp[k] += h
        tm[k] -= h
        fd = (f(tp) - f(tm)) / (2 * h)
        col = jac_f[..., k]
        assert float((fd - col).abs().max()) <= 1e-5 * float(
            col.abs().max()), k


def test_vmap_over_thetas_runs_lanes(geom):
    """A vmap over thetas is the lanes route: each row equals its single
    call, and its jvp along one direction per lane too."""
    f = _probs(geom, 1, FLAGSHIP_ACTIVE)
    thetas = torch.tensor([THETA, [t * 1.02 for t in THETA]],
                          dtype=torch.float64)
    dirs = torch.as_tensor(np.random.RandomState(4).normal(size=(2, 6)))
    batched = torch.func.vmap(f)(thetas)
    tangents = torch.func.vmap(
        lambda t, d: torch.func.jvp(f, (t,), (d,))[1])(thetas, dirs)
    for b in range(2):
        np.testing.assert_allclose(batched[b].numpy(), f(thetas[b]).numpy(),
                                   rtol=0, atol=1e-15)
        want = torch.func.jvp(f, (thetas[b],), (dirs[b],))[1]
        np.testing.assert_allclose(tangents[b].numpy(), want.numpy(),
                                   rtol=0, atol=1e-13 * float(
                                       want.abs().max()))


def test_jacfwd_through_the_stacked_flagship():
    """The template's Jacobian through the stacked stages and the factorized
    histogram (rate deferral) of the 20x20-grid flagship: the theta23 and
    aeff-scale columns against central differences of the template."""
    from test_torch_pipeline import _small_grid_config
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning

    ct = Pipeline(_small_grid_config(parse_pipeline_config, binning, ureg),
                  device="cpu").compile()
    assert ct.stacked and ct.rate_deferred
    v = ct.current_rescaled_values()
    mu, jac = _template_jacobian(ct, v)
    assert jac.shape == (mu.size, len(ct.free_names))

    def total(x):
        out = ct(x)["hist"]
        return np.concatenate([out[n].numpy() for n in sorted(out)])

    np.testing.assert_allclose(total(v), mu, rtol=1e-14)
    for name in ("theta23", "aeff_scale"):
        i = ct.free_names.index(name)
        vp, vm = v.copy(), v.copy()
        vp[i] += 1e-5
        vm[i] -= 1e-5
        fd = (total(vp) - total(vm)) / 2e-5
        assert np.abs(fd - jac[:, i]).max() <= 1e-7 * np.abs(jac[:, i]).max()


def _toy_tiny(tmp_path_factory):
    src = open(find_resource("settings/pipeline/toy_fit_example.cfg")).read()
    path = tmp_path_factory.mktemp("fisher") / "toy_tiny.cfg"
    path.write_text(src.replace("calc_grid_coarse", "tiny_grid"))
    return str(path)


@pytest.fixture(scope="module")
def templates(tmp_path_factory):
    """(JAX template, port template) of the tiny-grid toy with theta23 and
    aeff_scale free (tests/test_fisher.py)."""
    path = _toy_tiny(tmp_path_factory)
    out = []
    for cls, kw in ((JaxPipeline, {}), (Pipeline, {"device": "cpu"})):
        p = cls(path, **kw)
        for prm in p.params.free:
            if prm.name not in ("theta23", "aeff_scale"):
                prm.is_fixed = True
        out.append(p.compile())
    return out


@pytest.mark.parametrize("priors", [False, True])
def test_fisher_matrix_matches_jax(templates, priors):
    jax_ct, ct = templates
    want = jax_fisher(jax_ct, priors=priors)
    got = get_fisher_matrix(ct, priors=priors)
    assert got.parameters == want.parameters == ["theta23", "aeff_scale"]
    assert got.units == want.units
    np.testing.assert_allclose(got.best_fits, want.best_fits, rtol=1e-12)
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=1e-8)
    assert np.all(np.linalg.eigvalsh(got.matrix) > 0)


def test_fisher_matches_llh_curvature(templates):
    """The fixed-others sigma of aeff_scale against the curvature of the
    port's own -ln L (tests/test_fisher.py)."""
    _, ct = templates
    fm = get_fisher_matrix(ct, priors=False)
    value_only, _ = ct.build_objective(ct.get_outputs(), "llh", priors=False)
    v0 = ct.current_rescaled_values()
    i = ct.free_names.index("aeff_scale")
    lo, hi = (b[i] for b in ct._current_bounds())
    vp, vm = v0.copy(), v0.copy()
    vp[i] += 0.01
    vm[i] -= 0.01
    curv = (float(value_only(vp)) - 2 * float(value_only(v0))
            + float(value_only(vm))) / 0.01**2 / (hi - lo) ** 2
    assert fm.get_sigma("aeff_scale", marginalized=False) == pytest.approx(
        1.0 / np.sqrt(curv), rel=0.05)


def test_pulls_match_jax_and_recover_a_shift(templates):
    jax_ct, ct = templates
    v = ct.current_rescaled_values()
    i = ct.free_names.index("aeff_scale")
    lo, hi = (b[i] for b in ct._current_bounds())
    v_shift = v.copy()
    v_shift[i] += 0.02
    data = {k: h.numpy() for k, h in ct(v_shift)["hist"].items()}
    got = calculate_pulls(ct, data)
    want = jax_pulls(jax_ct, data)
    for name in want:  # theta23's pull is round-off (~1e-14)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-8,
                                   atol=1e-12)
    assert got["aeff_scale"] == pytest.approx(0.02 * (hi - lo), rel=0.05)
    maps = ct.get_outputs(v_shift)
    np.testing.assert_allclose(calculate_pulls(ct, maps)["aeff_scale"],
                               got["aeff_scale"], rtol=1e-12)


def test_fisher_matrix_operations_match_jax():
    m = np.array([[4.0, 1.0], [1.0, 2.0]])
    for cls in (FisherMatrix, JaxFisherMatrix):
        fm = cls(m.copy(), ["a", "b"], [0.0, 0.0])
        assert fm.get_sigma("a") > fm.get_sigma("a", marginalized=False)
        fm.add_prior("b", 0.5)
        assert fm.matrix[1, 1] == pytest.approx(6.0)
    got, want = (cls(m.copy(), ["a", "b"], [0.0, 0.0], priors={"a": 2.0})
                 for cls in (FisherMatrix, JaxFisherMatrix))
    np.testing.assert_allclose(got.correlation(), want.correlation(),
                               rtol=1e-15)
    assert str(got) == str(want)
    fixed = FisherMatrix(m.copy(), ["a", "b"], [0.0, 0.0])
    fixed.fix_parameter("b")
    assert fixed.parameters == ["a"]
    assert fixed.get_sigma("a") == pytest.approx(0.5)
    marg = FisherMatrix(m.copy(), ["a", "b"], [0.0, 0.0])
    sigma_a = marg.get_sigma("a")
    marg.remove_parameter("b")
    assert marg.get_sigma("a") == pytest.approx(sigma_a)
    with pytest.raises(ValueError, match="shape"):
        FisherMatrix(m, ["a"], [0.0])


def test_json_round_trip_through_the_jax_file(tmp_path):
    m = np.array([[4.0, 1.0], [1.0, 2.0]])
    JaxFisherMatrix(m, ["a", "b"], [0.5, 1.5], units=["deg", ""]).to_json(
        str(tmp_path / "jax.json"))
    fm = FisherMatrix.from_json(str(tmp_path / "jax.json"))
    assert fm.parameters == ["a", "b"] and fm.units == ["deg", ""]
    np.testing.assert_array_equal(fm.matrix, m)
    assert fm.best_fits == [0.5, 1.5]
    fm.to_json(str(tmp_path / "port.json"))
    back = JaxFisherMatrix.from_json(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(back.matrix, m)
    assert back.parameters == ["a", "b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_forward_mode_launches_on_the_card(cuda_device):
    """On the card a jvp is one tangent launch and jacfwd one multitangent
    launch (the vmap rule), float64, each equal to the CPU's plain
    versions within 1e-10 of the largest entry."""
    rng = np.random.RandomState(7)
    n, n_layers = 500, 8
    e = 10 ** rng.uniform(0, 3, n)
    dens = rng.uniform(1, 12, (n, n_layers))
    dist = rng.uniform(50, 1000, (n, n_layers))
    geoms = {d: chain.prepare_chain_geometry(e, dens, dist,
                                             dtype=torch.float64, device=d)
             for d in ("cpu", cuda_device)}
    v = torch.as_tensor(rng.normal(size=6))
    got = {}
    for d, geom in geoms.items():
        f = _probs(geom, -1, FLAGSHIP_ACTIVE)
        theta = torch.tensor(THETA, dtype=torch.float64, device=d)
        before = (chain.tangent_launch_count, chain.multitangent_launch_count)
        _, jv = torch.func.jvp(f, (theta,), (v.to(d),))
        jac = torch.func.jacfwd(f)(theta)
        after = (chain.tangent_launch_count, chain.multitangent_launch_count)
        got[str(d)] = (jv.cpu(), jac.cpu(), (after[0] - before[0],
                                             after[1] - before[1]))
    (jv_cpu, jac_cpu, _), (jv, jac, launches) = got["cpu"], got[
        str(cuda_device)]
    assert launches == (1, 1)
    assert float((jv - jv_cpu).abs().max()) <= 1e-10 * float(
        jv_cpu.abs().max())
    assert float((jac - jac_cpu).abs().max()) <= 1e-10 * float(
        jac_cpu.abs().max())
