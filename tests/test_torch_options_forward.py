"""
Forward mode under prob3's options, in fp64 on the CPU (conftest).

(a) ``OscProbsGeneral`` (``pisa_tpu_torch/ops/osc/chain.py``) at NSI+LRI
    physics on the seeded Earth chains of tests/test_torch_osc_general.py:
    its jvp against its backward (<v, J u> = <J^T v, u>), and
    ``torch.func.jacfwd`` (the vmap rule of its tangent: ceil(K / 6)
    multitangent launches, one tangent launch for K = 1) against
    ``torch.func.jacrev`` (the general formulation's reverse mode), both
    within 1e-10, at K = 1, 6 and 8 directions.
(b) ``get_fisher_matrix`` against the JAX package's (``jax.jacfwd``
    through its XLA formulation) at tests/test_torch_fisher.py's bounds
    (best fits rtol 1e-12, matrix rtol 1e-8 per entry, and 1e-12 of
    sqrt(F_ii F_jj) for the entries that are round-off of a zero
    correlation) under NSI (standard and
    vacuum-like), LRI (emu), decay and layer dedup, on the toy
    ``osc_example_coarse.cfg`` with its grids cut to ``tiny_grid`` (8x8),
    with theta23, delta_index and the option's coupling free (the toy has
    no effective-area stage, so delta_index, its free flux param, takes
    aeff_scale's place).
"""

import math

import numpy as np
import pytest
import torch

from pisa_tpu.analysis.fisher import get_fisher_matrix as jax_fisher
from pisa_tpu.core.pipeline import Pipeline as JaxPipeline
from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
from pisa_tpu_torch.core.pipeline import Pipeline as TorchPipeline
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.ops.osc import layers as torch_layers
from pisa_tpu_torch.ops.osc import nonstandard
from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix
from test_torch_prob3_options import (  # noqa: F401 (a fixture)
    COUPLING,
    _toy,
    tiny_toy,
)

# (a): the physics point: theta13, theta23, dm31 [1e-3 eV^2], eps_ee,
# eps_mutau_magn, eps_mutau_phase, eps_emu_magn, v_lri [1e-14 eV] (each
# direction O(1)); the first K are the Jacobian's inputs
POINT = [0.15, 0.8, 2.5, 0.2, 0.12, 2.0, 0.05, 3.0]
EPS = {"eps_ee": 0.2, "eps_emu_magn": 0.05, "eps_emu_phase": 0.3,
       "eps_etau_magn": 0.07, "eps_etau_phase": -1.1, "eps_mumu": -0.1,
       "eps_mutau_magn": 0.12, "eps_mutau_phase": 2.0, "eps_tautau": 0.15}
AD_RTOL = 1e-10
# (b): option -> its free coupling
FISHER = {o: COUPLING.get(o) for o in ("nsi-standard", "nsi-vacuum-like",
                                       "lri-emu", "decay", "dedup")}


@pytest.fixture(scope="module")
def geom():
    rng = np.random.RandomState(11)
    lay = torch_layers.Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    lay.setElecFrac(0.4656, 0.4656, 0.4957)
    n = 40
    lay.calcLayers(rng.uniform(-1, 1, n))
    energy = 10 ** rng.uniform(0, 2, n)
    return chain.prepare_chain_geometry(
        energy, lay.density.reshape(n, -1), lay.distance.reshape(n, -1),
        dtype=torch.float64, device="cpu", general=True)


def _probs(geom, nubar, k):
    """The general route's probabilities as a function of the first `k`
    entries of POINT (or of lanes of them)."""
    fixed = torch.tensor(POINT, dtype=torch.float64)

    def f(x):  # x (k,), or (B, k) lanes
        lead = x.shape[:-1]
        p = list(x.unbind(-1)) + [c.expand(lead) for c in fixed[k:].unbind()]
        t13, t23, dm31, ee, magn, phase, emu, v = p
        t12, dcp, dm21 = (fixed.new_tensor(c).expand(lead)
                          for c in (0.58, 3.5, 7.4e-5))
        mix = pmns_matrix(torch.sin(t12), torch.sin(t13), torch.sin(t23), dcp)
        dm = dm_matrix(dm21, dm31 * 1e-3)
        eps = dict(EPS, eps_ee=ee, eps_mutau_magn=magn, eps_mutau_phase=phase,
                   eps_emu_magn=emu)
        mat_pot = torch.zeros((3, 3), dtype=torch.complex128)
        mat_pot[0, 0] = 1.0
        mat_pot = mat_pot + nonstandard.std_nsi_eps(*eps.values())
        lri = nonstandard.lri_potential(v * 1e-14, "emu-symmetry")
        return chain.osc_probs_general(dm, mix, mat_pot, lri, nubar, geom)

    return f, fixed[:k]


def _counting(monkeypatch):
    """Counts the calls of the tangent and multitangent wrappers."""
    calls = {"tangent": 0, "multitangent": 0}
    for name in calls:
        fn = getattr(chain, f"chain_{name}")

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(chain, f"chain_{name}", counted)
    return calls


@pytest.mark.parametrize("nubar", [1, -1])
def test_general_jvp_is_the_transpose_of_the_backward(geom, nubar,
                                                      monkeypatch):
    """<v, J u> = <J^T v, u> for a seeded direction u of all 8 inputs and a
    seeded cotangent v; the jvp is one tangent launch."""
    f, x = _probs(geom, nubar, len(POINT))
    rng = np.random.RandomState(3)
    u = torch.as_tensor(rng.normal(size=len(POINT)))
    v = torch.as_tensor(rng.uniform(size=(geom["e"].shape[0], 3, 3)))
    calls = _counting(monkeypatch)
    _, ju = torch.func.jvp(f, (x,), (u,))
    assert calls == {"tangent": 1, "multitangent": 0}
    xg = x.clone().requires_grad_(True)
    (jtv,) = torch.autograd.grad((f(xg) * v).sum(), xg)
    np.testing.assert_allclose(float((ju * v).sum()), float((jtv * u).sum()),
                               rtol=AD_RTOL)


@pytest.mark.parametrize("k", [1, 6, 8])
def test_general_jacfwd_equals_jacrev(geom, k, monkeypatch):
    """jacfwd over K inputs (one tangent launch at K = 1, else ceil(K / 6)
    multitangent launches) against jacrev, within 1e-10 of the largest
    entry, on a seeded projection of the probabilities (antineutrinos)."""
    f, x = _probs(geom, -1, k)
    weights = torch.as_tensor(np.random.RandomState(k).normal(
        size=(4, geom["e"].shape[0], 3, 3)))

    def g(y):
        return (weights * f(y)).sum(dim=(1, 2, 3))

    calls = _counting(monkeypatch)
    jac_f = torch.func.jacfwd(g)(x)
    want = ({"tangent": 1, "multitangent": 0} if k == 1 else
            {"tangent": 0, "multitangent": math.ceil(k / chain.MAX_TANGENTS)})
    assert calls == want
    jac_r = torch.func.jacrev(g)(x)
    assert jac_f.shape == (4, k)
    scale = float(jac_r.abs().max())
    assert scale > 0 and all(float(jac_r[:, i].abs().max()) > 0
                             for i in range(k))
    assert float((jac_f - jac_r).abs().max()) <= AD_RTOL * scale


@pytest.mark.parametrize("option", list(FISHER))
def test_fisher_matrix_under_option_matches_jax(option, tiny_toy):
    free = FISHER[option]
    jax_ct = JaxPipeline(_toy(option, "jax", free=free,
                              path=tiny_toy)).compile()
    ct = TorchPipeline(_toy(option, "torch", free=free, path=tiny_toy),
                       device="cpu").compile()
    want = jax_fisher(jax_ct)
    got = get_fisher_matrix(ct)
    assert got.parameters == want.parameters
    assert free is None or free in got.parameters
    np.testing.assert_allclose(got.best_fits, want.best_fits, rtol=1e-12)
    # rtol 1e-8 per entry; an entry that is round-off of a zero
    # correlation (~1e-16 of sqrt(F_ii F_jj)) is held at 1e-12 of that scale
    scale = np.sqrt(np.outer(np.diag(want.matrix), np.diag(want.matrix)))
    assert np.all(np.abs(got.matrix - want.matrix)
                  <= 1e-8 * np.abs(want.matrix) + 1e-12 * scale)
    assert np.all(np.linalg.eigvalsh(got.matrix) > 0)


def test_vmap_over_laned_points_runs_lanes(geom):
    """A vmap of the jvp over points that already carry lanes ((2, 2)
    points: the vmap axis and the lanes merged into the launch's lanes)
    equals each point's own jvp, on the general route and on the standard
    one (``OscProbs``), within 1e-12 of the largest entry."""
    rng = np.random.RandomState(9)
    f, x = _probs(geom, 1, len(POINT))
    xs = x * torch.as_tensor(1.0 + 0.02 * rng.normal(size=(2, 2, len(POINT))))
    dirs = torch.as_tensor(rng.normal(size=(2, 2, len(POINT))))
    theta = torch.tensor([0.59, 0.15, 0.86, 3.4, 7.4e-5, 2.5e-3],
                         dtype=torch.float64)
    thetas = theta * torch.as_tensor(1.0 + 0.02 * rng.normal(size=(2, 2, 6)))
    dthetas = torch.as_tensor(rng.normal(size=(2, 2, 6))) * theta

    def standard(t):
        return chain.osc_probs(t, 1, geom)

    for fn, points, tangents in ((f, xs, dirs), (standard, thetas, dthetas)):
        def jvp(p, d, fn=fn):
            return torch.func.jvp(fn, (p,), (d,))[1]

        got = torch.func.vmap(jvp)(points, tangents)
        for v in range(2):
            for b in range(2):
                want = jvp(points[v, b], tangents[v, b])
                assert float((got[v, b] - want).abs().max()) <= 1e-12 * float(
                    want.abs().max())
