"""
The port's Earth-layer chain (``pisa_tpu_torch.ops.osc.chain``) against the
JAX package: the 57-scalar pack, the plain torch version against the Pallas
kernel (interpret mode) and the XLA path, and the CUDA kernel against the
plain version on a card (``cuda`` marker; skipped without one).

Inputs are made with numpy from a seed and reach both packages through
``pisa_tpu_torch.utils.interop``; the suite runs in fp64 (conftest).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu.ops.cplx import C
from pisa_tpu.ops.osc import pallas_chain
from pisa_tpu.ops.osc.kernels import osc_probs_layers
from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.interop import chain_inputs_from_jax

# (theta12, theta13, theta23, deltacp) [rad], (dm21, dm31) [eV^2]
THETA = np.array([0.5903, 0.1503, 0.8587, 3.4, 7.39e-5, 2.528e-3])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _geometry(n, n_layers=8, seed=7):
    """Random energies and layer chains of random lengths (0..L layers),
    zero-padded like the Earth-model chains."""
    rng = np.random.RandomState(seed)
    e = 10 ** rng.uniform(0, 3, n)
    dens = rng.uniform(1, 12, (n, n_layers))
    dist = rng.uniform(50, 1000, (n, n_layers))
    nl = rng.randint(0, n_layers + 1, n)
    for i, k in enumerate(nl):
        dens[i, k:] = 0.0
        dist[i, k:] = 0.0
    return e, dens, dist


def _jax_pvec(nubar, reparam=False, nlo_factor=1.0, theta=THETA):
    return np.asarray(
        pallas_chain._theta_to_pvec(
            jnp.asarray(theta), reparam, nubar, nlo_factor, jnp.float64
        )
    )


def _jax_prepared(e, dens, dist):
    order = np.argsort(
        np.count_nonzero(dist > 0, axis=1), kind="stable"
    ).astype(np.int32)
    return pallas_chain.prepare_chain_geometry(e, dens, dist, order=order)


@pytest.mark.parametrize("nubar", [1, -1])
@pytest.mark.parametrize("reparam,nlo_factor", [(False, 1.0), (True, 1.02)])
def test_pack_matches_jax(nubar, reparam, nlo_factor):
    """Same layout and values as ``pallas_chain._theta_to_pvec`` (fp64
    round-off only)."""
    want = _jax_pvec(nubar, reparam, nlo_factor)
    got = chain.theta_to_pvec(THETA, nubar, reparam, nlo_factor).numpy()
    assert got.shape == (chain.N_PACK,) and want.shape == (1, chain.N_PACK)
    np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-14)


@pytest.mark.parametrize("n", [300, 301])
@pytest.mark.parametrize("nubar", [1, -1])
def test_reference_matches_pallas_interpret(nubar, n):
    """Plain torch version vs the Pallas kernel run by the interpreter, from
    the identical pack and blocked geometry (odd n exercises the padding).
    The Pallas kernel's atan polynomial has max error 1.8e-9
    (pallas_chain.py:116-117), hence atol 1e-6."""
    e, dens, dist = _geometry(n)
    jp = _jax_pvec(nubar)
    jgeom = _jax_prepared(e, dens, dist)
    want = np.asarray(
        pallas_chain.chain_probs_pallas_prepared(
            jnp.asarray(jp), jgeom, n, interpret=True
        )
    )
    pvec, geom = chain_inputs_from_jax(jp, jgeom, n)
    got = chain.osc_probs_prepared(pvec, geom).numpy()
    assert got.shape == want.shape == (n, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_interop_geometry_matches_prepare():
    """The port's own geometry preparation gives exactly the arrays that
    interop recovers from the JAX package's blocked geometry."""
    e, dens, dist = _geometry(301)
    _, from_jax = chain_inputs_from_jax(
        _jax_pvec(1), _jax_prepared(e, dens, dist), 301
    )
    own = chain.prepare_chain_geometry(
        e, dens, dist, dtype=torch.float64, device="cpu"
    )
    for key in ("e", "dens", "dist", "nl", "order", "inv"):
        assert torch.equal(own[key], from_jax[key]), key
    for key, value in own["tiles"].items():
        assert torch.equal(value, from_jax["tiles"][key]), key


def _check_tile_table(steps):
    """A tile table cut to `steps` steps a tile: tiles cover the sorted points
    in order; every real step (distance > 0) appears exactly once, in chain
    order, with its point's tile-local index; no point is split across
    tiles; no tile exceeds `steps` steps or TILE_POINTS points; points with no
    real step keep their slot (here enough of them to fill tiles by the
    point cap)."""
    rng = np.random.RandomState(23)
    e, dens, dist = _geometry(900, seed=13)
    dist[rng.uniform(size=dist.shape) < 0.2] = 0.0  # zero-length gaps
    dist[:150] = 0.0  # points with no real step
    geom = chain.prepare_chain_geometry(
        e, dens, dist, dtype=torch.float64, device="cpu"
    )
    order = geom["order"].numpy()
    d_sorted, r_sorted = dist[order], dens[order]
    if steps == chain.TILE_STEPS:
        tiles = geom["tiles"]
    else:
        tiles = chain.tile_table(r_sorted, d_sorted, dtype=torch.float64,
                                 device="cpu", steps=steps)
    t = {k: v.numpy() for k, v in tiles.items()}
    n = e.size
    first, n_points, first_step, n_steps = t["tile"].T
    point_step = t["point_step"]

    assert t["steps"] == steps
    assert first[0] == 0 and first[-1] + n_points[-1] == n
    np.testing.assert_array_equal(first[1:], first[:-1] + n_points[:-1])
    np.testing.assert_array_equal(first_step, point_step[first])
    np.testing.assert_array_equal(first_step + n_steps,
                                  point_step[first + n_points])
    assert np.all(n_points >= 1) and n_points.max() == chain.TILE_POINTS
    assert n_steps.max() <= steps
    assert point_step[-1] == t["rho"].size == np.count_nonzero(dist > 0)
    for k in range(first.size):
        for j in range(n_points[k]):
            i = first[k] + j
            real = d_sorted[i] > 0
            at = slice(point_step[i], point_step[i + 1])
            np.testing.assert_array_equal(t["dx"][at], d_sorted[i][real])
            np.testing.assert_array_equal(t["rho"][at], r_sorted[i][real])
            assert np.all(t["step_point"][at] == j)
    empty = np.diff(point_step) == 0
    assert empty.sum() == np.count_nonzero(~(dist > 0).any(axis=1)) >= 150


def test_tile_table():
    """The tile table of the primal and tangent kernels, as
    prepare_chain_geometry builds it (TILE_STEPS steps, TILE_POINTS points a
    tile)."""
    _check_tile_table(chain.TILE_STEPS)


@pytest.mark.parametrize("steps", [64, 24, 96])
def test_tile_table_at_shape(steps):
    """Tile tables cut to fewer steps a tile, as the multitangent kernel
    also takes them: no point split, every real step once, zero-step points
    kept."""
    _check_tile_table(steps)


def test_tile_table_rejects_long_chain():
    dens = np.ones((3, chain.TILE_STEPS + 1))
    with pytest.raises(ValueError, match="exceeds"):
        chain.tile_table(dens, dens, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nubar", [1, -1])
def test_reference_matches_xla(nubar):
    """Plain torch version vs the XLA path ``osc_probs_layers``, as
    tests/test_pallas_chain.py:67 holds the Pallas kernel to it."""
    n = 300
    e, dens, dist = _geometry(n, seed=11)
    mix = pmns_matrix(
        jnp.sin(THETA[0]), jnp.sin(THETA[1]), jnp.sin(THETA[2]), THETA[3]
    )
    want = np.asarray(
        osc_probs_layers(
            dm_matrix(THETA[4], THETA[5]),
            mix,
            C.of(np.diag([1.0, 0.0, 0.0]).astype(np.complex128)),
            C.of(np.zeros((3, 3), np.complex128)),
            np.zeros((3, 3)),
            nubar,
            e,
            dens,
            dist,
        )
    )
    geom = chain.prepare_chain_geometry(
        e, dens, dist, dtype=torch.float64, device="cpu"
    )
    got = chain.osc_probs_prepared(chain.theta_to_pvec(THETA, nubar), geom)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # rows are probability distributions
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=2e-5)


def test_sort_permutation_invariance():
    """The chain-length sort changes only the order in which points are
    computed: the unsorted layer-major slabs give the same probabilities."""
    e, dens, dist = _geometry(300, seed=5)
    pvec = chain.theta_to_pvec(THETA, -1)
    sorted_probs = chain.osc_probs_prepared(
        pvec,
        chain.prepare_chain_geometry(
            e, dens, dist, dtype=torch.float64, device="cpu"
        ),
    )
    assert not np.array_equal(
        np.argsort(np.count_nonzero(dist > 0, axis=1), kind="stable"),
        np.arange(300),
    )
    t = torch.as_tensor
    p2 = chain.chain_probs(
        pvec,
        t(e),
        t(np.ascontiguousarray(dens.T)),
        t(np.ascontiguousarray(dist.T)),
        t(np.count_nonzero(dist > 0, axis=1), dtype=torch.int32),
    )
    np.testing.assert_allclose(
        sorted_probs.numpy(), chain.tau_epilogue(p2).numpy(), rtol=0,
        atol=1e-13,
    )


def test_chain_probs_rejects_bad_inputs():
    e, dens, dist = _geometry(16)
    geom = chain.prepare_chain_geometry(
        e, dens, dist, dtype=torch.float64, device="cpu"
    )
    pvec = chain.theta_to_pvec(THETA, 1)
    args = [geom["e"], geom["dens"], geom["dist"], geom["nl"]]
    with pytest.raises(ValueError, match="pvec"):
        chain.chain_probs(pvec.float(), *args)
    with pytest.raises(ValueError, match="dens/dist"):
        chain.chain_probs(pvec, args[0], args[1].T.contiguous(), *args[2:])
    with pytest.raises(ValueError, match="nl"):
        chain.chain_probs(pvec, *args[:3], geom["nl"].long())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_kernel_matches_reference_on_card(cuda_device, dtype, atol):
    """The CUDA (tile) kernel against the plain version on the same card, on
    PREM-12 chains (the flagship's Earth model), the launch count rising by
    one per launch, and a launch without the tile table refused. float32 differs by rounding (FMA contraction in the
    kernel), amplified at high energy where the char-poly eigenvalues of
    the matter-dominated Hamiltonian lose precision."""
    from pisa_tpu_torch.ops.osc.layers import Layers

    rng = np.random.RandomState(3)
    n = 4099
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    layers.calcLayers(rng.uniform(-1, 1, n))
    shape = (n, layers.max_layers)
    geom = chain.prepare_chain_geometry(
        10 ** rng.uniform(0, 3, n),
        layers.density.reshape(shape),
        layers.distance.reshape(shape),
        dtype=dtype,
        device=cuda_device,
    )
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    for nubar in (1, -1):
        pvec = chain.theta_to_pvec(THETA, nubar).to(cuda_device, dtype)
        before = chain.launch_count
        got = chain.chain_probs(pvec, *args, geom["tiles"])
        assert chain.launch_count == before + 1
        want = chain.chain_probs_reference(pvec, *args)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= atol
    with pytest.raises(ValueError, match="tile table"):
        chain.chain_probs(pvec, *args)
    assert chain.launch_count == before + 1


# three lanes of theta (both signs of dm31)
LANE_THETAS = np.array([
    THETA,
    [0.6, 0.14, 0.70, 1.0, 7.5e-5, -2.4e-3],
    [0.58, 0.16, 0.92, 0.2, 7.2e-5, 2.6e-3],
])
LANE_ACTIVE = [1, 2, 5]  # theta13, theta23, dm31: the flagship's free ones


def _lane_inputs(nubar, device="cpu", dtype=torch.float64, n=300):
    e, dens, dist = _geometry(n, seed=11)
    geom = chain.prepare_chain_geometry(e, dens, dist, dtype=dtype,
                                        device=device)
    theta = torch.as_tensor(LANE_THETAS, dtype=torch.float64)
    pvec = chain.theta_to_pvec(theta, nubar)
    dirs = chain.pack_jacobian(theta, nubar)[..., LANE_ACTIVE].transpose(1, 2)
    return (geom, pvec.to(device, dtype).contiguous(),
            dirs.to(device, dtype).contiguous())


@pytest.mark.parametrize("nubar", [1, -1])
def test_pack_lanes_equal_single_packs(nubar):
    """theta_to_pvec and pack_jacobian over (B, 6) lanes: each lane is the
    single theta's pack and 57x6 Jacobian (no cross-lane blocks)."""
    theta = torch.as_tensor(LANE_THETAS, dtype=torch.float64)
    packs = chain.theta_to_pvec(theta, nubar)
    jacs = chain.pack_jacobian(theta, nubar)
    assert packs.shape == (3, chain.N_PACK)
    assert jacs.shape == (3, chain.N_PACK, 6)
    for b in range(3):
        np.testing.assert_allclose(
            packs[b].numpy(), chain.theta_to_pvec(theta[b], nubar).numpy(),
            rtol=0, atol=1e-16)
        np.testing.assert_allclose(
            jacs[b].numpy(), chain.pack_jacobian(theta[b], nubar).numpy(),
            rtol=0, atol=1e-16)


@pytest.mark.parametrize("which", ["primal", "tangent", "multitangent"])
def test_reference_lanes_equal_single_calls(which):
    """The plain versions with a lane axis: (B, 57) packs (and (B, 57) or
    (B, K, 57) directions) give each lane's single call, to rounding
    (1e-13 of the largest output; fp64)."""
    geom, pvec, dirs = _lane_inputs(1)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    if which == "primal":
        got = [chain.chain_probs(pvec, *args)]
        want = [torch.stack([chain.chain_probs(p, *args) for p in pvec])]
    elif which == "tangent":
        d = dirs[:, 1].contiguous()
        got = [chain.chain_tangent(pvec, d, *args)]
        want = [torch.stack([chain.chain_tangent(p, x, *args)
                             for p, x in zip(pvec, d)])]
    else:
        got = list(chain.chain_multitangent(pvec, dirs, *args))
        ones = [chain.chain_multitangent(p, d, *args)
                for p, d in zip(pvec, dirs)]
        want = [torch.stack([o[0] for o in ones]),
                torch.stack([o[1] for o in ones])]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 3
        assert float((g - w).abs().max()) <= 1e-13 * float(w.abs().max())


@pytest.mark.parametrize("multitangent", [True, False])
def test_osc_probs_lanes_equal_single_theta(multitangent):
    """OscProbs over (B, 6) lanes of theta: the probabilities and the
    gradient of a weighted sum equal each lane's single-theta call (1e-12
    relative; fp64), on both backward routes."""
    geom, _, _ = _lane_inputs(-1)
    rng = np.random.RandomState(5)
    w = torch.as_tensor(rng.uniform(size=(geom["e"].shape[0], 3, 3)))
    theta = torch.as_tensor(LANE_THETAS, dtype=torch.float64)
    th = theta.clone().requires_grad_(True)
    probs = chain.osc_probs(th, -1, geom, active=LANE_ACTIVE,
                            multitangent=multitangent)
    (probs * w).sum().backward()
    for b in range(3):
        tb = theta[b].clone().requires_grad_(True)
        pb = chain.osc_probs(tb, -1, geom, active=LANE_ACTIVE,
                             multitangent=multitangent)
        (pb * w).sum().backward()
        np.testing.assert_allclose(probs[b].detach().numpy(),
                                   pb.detach().numpy(), rtol=0, atol=1e-14)
        np.testing.assert_allclose(th.grad[b].numpy(), tb.grad.numpy(),
                                   rtol=1e-12, atol=0)
    assert np.all(th.grad[:, [0, 3, 4]].numpy() == 0.0)


def test_chain_probs_rejects_bad_lanes():
    """Directions whose lanes do not match the packs', and more lanes than
    a launch takes, are refused before any launch."""
    geom, pvec, dirs = _lane_inputs(1)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    with pytest.raises(ValueError, match="dpvecs"):
        chain.chain_multitangent(pvec, dirs[:2], *args)
    with pytest.raises(ValueError, match="dpvec"):
        chain.chain_tangent(pvec, dirs[0, 0], *args)
    big = pvec[:1].expand(chain.MAX_LANES + 1, -1)
    with pytest.raises(ValueError, match="lanes"):
        chain.chain_probs(big, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("which", ["primal", "tangent", "multitangent"])
def test_lane_kernels_on_card(cuda_device, dtype, atol, which):
    """Each batched CUDA kernel (B = 3 lanes, one launch) against its plain
    version's lane axis on the card (the single-launch bounds: primal atol,
    tangents relative to their direction's largest), and lane b against a
    single launch at pack b: equal in fp64 (the same code in the same
    order), within rounding in fp32."""
    geom, pvec, dirs = _lane_inputs(1, cuda_device, dtype, n=4099)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    tiles = geom["tiles"]
    counter = {"primal": "launch_count", "tangent": "tangent_launch_count",
               "multitangent": "multitangent_launch_count"}[which]
    if which == "primal":
        def run(p, d):
            return chain.chain_probs(p, *args, tiles), None
        want = (chain.chain_probs_reference(pvec, *args), None)
        d = None
    elif which == "tangent":
        def run(p, d):
            return None, chain.chain_tangent(p, d, *args, tiles)
        d = dirs[:, 1].contiguous()
        want = (None, chain.chain_tangent_reference(pvec, d, *args))
    else:
        def run(p, d):
            return chain.chain_multitangent(p, d, *args, tiles)
        d = dirs
        want = chain.chain_multitangent_reference(pvec, d, *args)
    before = getattr(chain, counter)
    got = run(pvec, d)
    assert getattr(chain, counter) == before + 1
    torch.cuda.synchronize()
    if got[0] is not None:
        assert float((got[0] - want[0]).abs().max()) <= atol
    if got[1] is not None:
        dims = tuple(range(1 - got[1].dim(), 0))[-3:]
        scale = want[1].abs().amax(dim=dims, keepdim=True)
        assert float(((got[1] - want[1]).abs() / scale).max()) <= 10 * atol
    for b in range(3):
        one = run(pvec[b].contiguous(), None if d is None
                  else d[b].contiguous())
        for g, o in zip(got, one):
            if g is None:
                continue
            if dtype == torch.float64:
                assert torch.equal(g[b], o)
            else:
                assert float((g[b] - o).abs().max()) <= atol
