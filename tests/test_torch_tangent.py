"""
The port's chain tangents and the oscillation gradient boundary
(``pisa_tpu_torch.ops.osc.chain``) against the JAX package: the plain
tangent and multitangent versions against ``jax.jvp`` of the XLA formulation
and against the Pallas tangent kernels run by the interpreter, the autograd
Function's theta gradient against the Pallas forward-mode gradient
(``osc_probs_layers_pallas_fwdgrad_prepared``), and the CUDA kernels against
the plain versions on a card (``cuda`` marker; skipped without one).

Inputs are made with numpy from a seed; the suite runs in fp64 (conftest).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu.ops.osc import pallas_chain
from pisa_tpu.ops.osc.kernels import _osc_probs_xla
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.utils.interop import chain_inputs_from_jax

# (theta12, theta13, theta23, deltacp) [rad], (dm21, dm31) [eV^2]
THETA = np.array([0.58, 0.15, 0.78, 1.2, 7.4e-5, 2.5e-3])
FREE = (1, 2, 5)  # theta13, theta23, dm31: the flagship's free ones


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def _geometry(n, n_layers=6, seed=3):
    """Random energies and layer chains of random lengths (1..L layers),
    zero-padded like the Earth-model chains."""
    rng = np.random.RandomState(seed)
    e = 10 ** rng.uniform(0, 2, n)
    nl = rng.randint(1, n_layers + 1, n)
    dens = rng.uniform(1, 10, (n, n_layers))
    dist = rng.uniform(50, 1000, (n, n_layers))
    for i, k in enumerate(nl):
        dens[i, k:] = 0.0
        dist[i, k:] = 0.0
    return e, dens, dist


def _layer_major(e, dens, dist):
    """Unsorted port inputs: (N,) energy, (L, N) slabs, per-point bounds."""
    t = torch.as_tensor
    return (t(e), t(np.ascontiguousarray(dens.T)),
            t(np.ascontiguousarray(dist.T)),
            t(np.count_nonzero(dist > 0, axis=1), dtype=torch.int32))


def _pack_and_jacobian(nubar, theta=THETA):
    """The port's pack and its 57x6 Jacobian in theta (columns = the
    directions the gradient's tangents run along)."""
    th = torch.as_tensor(theta)
    jac = torch.func.jacfwd(lambda t: chain.theta_to_pvec(t, nubar))(th)
    return chain.theta_to_pvec(th, nubar), jac


def _rel_err_per_direction(got, want):
    """max |got - want| over each direction's output, relative to that
    output's max |want|; `got`/`want` (K, ...)."""
    got, want = np.asarray(got), np.asarray(want)
    axes = tuple(range(1, want.ndim))
    return np.abs(got - want).max(axis=axes) / np.abs(want).max(axis=axes)


@pytest.mark.parametrize("nubar", [1, -1])
def test_tangent_reference_matches_xla_jvp(nubar):
    """d probs / d theta_k for all 6 components: the plain tangent along the
    pack Jacobian's column k against jax.jvp of the XLA formulation
    (``_osc_probs_xla``) along e_k; the same math in fp64, so 1e-10 of each
    direction's largest tangent."""
    e, dens, dist = _geometry(120, seed=11)
    args = _layer_major(e, dens, dist)
    pvec, jac = _pack_and_jacobian(nubar)
    got = torch.stack(
        [chain.chain_tangent_reference(pvec, jac[:, k], *args)
         for k in range(6)]
    ).numpy()  # (6, 2, 3, N)

    def probs(th):
        dm_vac, U, mat_pot, lri_pot = pallas_chain._build_standard(
            th, False, nubar, 1.0, jnp.float64
        )
        return _osc_probs_xla(
            dm_vac, U, mat_pot, None, lri_pot, nubar, jnp.asarray(e),
            jnp.asarray(dens), jnp.asarray(dist),
        )

    want = np.stack([
        np.asarray(jax.jvp(probs, (jnp.asarray(THETA),),
                           (jnp.asarray(np.eye(6)[k]),))[1])
        for k in range(6)
    ])  # (6, N, 3, 3)
    want = want[:, :, :2, :].transpose(0, 2, 3, 1)
    assert np.all(np.abs(want).max(axis=(1, 2, 3)) > 0)
    assert _rel_err_per_direction(got, want).max() < 1e-10


@pytest.mark.parametrize("nubar", [1, -1])
def test_tangent_reference_matches_pallas_interpret(nubar):
    """All 6 pack-Jacobian directions against the Pallas tangent kernel run
    by the interpreter, from the same pack and geometry. The Pallas kernel
    computes its eigenvalue angle with an atan polynomial of max error
    1.8e-9 (pallas_chain.py:116-117), the port with atan2; that difference
    reaches the tangents at ~1e-7 of their size (the JAX package sees the
    same between its Pallas and XLA gradients,
    tests/test_pallas_chain.py:250-253), hence 1e-6."""
    n = 64
    e, dens, dist = _geometry(n, seed=5)
    args = _layer_major(e, dens, dist)
    pvec, jac = _pack_and_jacobian(nubar)
    got = torch.stack(
        [chain.chain_tangent_reference(pvec, jac[:, k], *args)
         for k in range(6)]
    ).numpy()
    jpv = jnp.asarray(pvec.numpy()[None])
    # one compiled program for the six directions: the interpreter's kernel
    # traced once rather than run op by op six times
    tangent = jax.jit(functools.partial(pallas_chain.chain_tangent_pallas,
                                        interpret=True))
    want = np.stack([
        np.asarray(tangent(
            jpv, jnp.asarray(jac[:, k].numpy()[None]), jnp.asarray(e),
            jnp.asarray(dens), jnp.asarray(dist),
        )).transpose(1, 2, 0)
        for k in range(6)
    ])  # (6, 2, 3, N)
    assert _rel_err_per_direction(got, want).max() < 1e-6


@pytest.mark.parametrize("nubar", [1, -1])
def test_multitangent_reference_matches_pallas_and_tangents(nubar):
    """The plain multitangent version (primal + K = 3 tangents) against the
    Pallas multitangent kernel run by the interpreter (1e-6 relative, the
    atan polynomial as above; the primal to 1e-6 absolute as in
    tests/test_torch_chain.py), and exactly against K separate plain
    tangents and the plain primal."""
    n = 64
    e, dens, dist = _geometry(n, seed=21)
    args = _layer_major(e, dens, dist)
    pvec, jac = _pack_and_jacobian(nubar)
    dpvecs = jac[:, list(FREE)].T.contiguous()
    p2, dp2 = chain.chain_multitangent_reference(pvec, dpvecs, *args)
    assert dp2.shape == (3, 2, 3, n)

    np.testing.assert_array_equal(
        p2.numpy(), chain.chain_probs_reference(pvec, *args).numpy())
    for k in range(3):
        np.testing.assert_array_equal(
            dp2[k].numpy(),
            chain.chain_tangent_reference(pvec, dpvecs[k], *args).numpy())

    e2, jdens, jdist, nl_blocks, _, _, _ = pallas_chain._prep_blocks(
        jnp.asarray(e), jnp.asarray(dens), jnp.asarray(dist))
    want_p, want_t = pallas_chain._launch_multitangent(
        jnp.asarray(pvec.numpy()[None]), jnp.asarray(dpvecs.numpy()), e2,
        jdens, jdist, nl_blocks, n, interpret=True,
    )  # (N, 2, 3), (K, N, 2, 3)
    np.testing.assert_allclose(p2.numpy(),
                               np.asarray(want_p).transpose(1, 2, 0),
                               rtol=0, atol=1e-6)
    want_t = np.asarray(want_t).transpose(0, 2, 3, 1)
    assert _rel_err_per_direction(dp2.numpy(), want_t).max() < 1e-6


def _jax_and_port_geometry(n, seed):
    e, dens, dist = _geometry(n, n_layers=5, seed=seed)
    dist[:, -1] = 0.0
    order = np.argsort(np.count_nonzero(dist > 0, axis=1),
                       kind="stable").astype(np.int32)
    jgeom = pallas_chain.prepare_chain_geometry(
        jnp.asarray(e), jnp.asarray(dens), jnp.asarray(dist), order=order)
    _, geom = chain_inputs_from_jax(np.zeros((1, 57)), jgeom, n)
    return jgeom, geom


@pytest.mark.parametrize(
    "active,multitangent",
    [(None, False), (FREE, False), (FREE, True)],
    ids=["all", "subset", "subset-multitangent"],
)
def test_function_gradient_matches_pallas_fwdgrad(active, multitangent,
                                                   monkeypatch):
    """The autograd Function's theta gradient of sum(w * probs) against the
    Pallas forward-mode gradient (interpreter) for all and for a subset of
    active components (tests/test_pallas_chain.py:422,482,518): the active
    entries to 1e-6 of the largest (the atan polynomial, as above), the
    inactive ones exactly zero."""
    n = 64
    jgeom, geom = _jax_and_port_geometry(n, seed=5)
    w = np.random.RandomState(7).uniform(-1, 1, (n, 3, 3))
    nubar = -1 if multitangent else 1
    monkeypatch.setenv("PISA_TPU_OSC_MULTITANGENT",
                       "1" if multitangent else "0")

    def jax_loss(th):
        return jnp.sum(jnp.asarray(w) * (
            pallas_chain.osc_probs_layers_pallas_fwdgrad_prepared(
                th, nubar, jgeom, n=n, interpret=True, active=active)))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(THETA)))
    theta = torch.tensor(THETA, requires_grad=True)
    probs = chain.osc_probs(theta, nubar, geom, active=active,
                            multitangent=multitangent)
    (got,) = torch.autograd.grad((torch.as_tensor(w) * probs).sum(), theta)
    got = got.numpy()
    on = list(range(6)) if active is None else list(active)
    off = [k for k in range(6) if k not in on]
    assert np.abs(got[on] - want[on]).max() / np.abs(want[on]).max() < 1e-6
    assert np.all(got[off] == 0.0) and np.all(want[off] == 0.0)


def test_function_forward_matches_primal():
    """The Function's forward is the primal with the tau row, unsorted."""
    _, geom = _jax_and_port_geometry(64, seed=9)
    for nubar in (1, -1):
        got = chain.osc_probs(THETA, nubar, geom)
        want = chain.osc_probs_prepared(chain.theta_to_pvec(THETA, nubar),
                                        geom)
        assert torch.equal(got, want)


@pytest.mark.parametrize("multitangent", [False, True])
def test_function_gradcheck(multitangent):
    """torch.autograd.gradcheck of the Function (all six components) against
    finite differences on a tiny chain."""
    _, geom = _jax_and_port_geometry(8, seed=13)
    w = torch.as_tensor(np.random.RandomState(1).uniform(-1, 1, (8, 3, 3)))
    # theta in units where finite differences are well conditioned
    scale = torch.tensor([1, 1, 1, 1, 1e-4, 1e-3], dtype=torch.float64)
    theta = (torch.as_tensor(THETA) / scale).requires_grad_(True)
    for nubar in (1, -1):
        assert torch.autograd.gradcheck(
            lambda t: (w * chain.osc_probs(
                t * scale, nubar, geom, multitangent=multitangent)).sum(),
            (theta,), eps=1e-6, atol=1e-7, rtol=1e-5,
        )


def test_multitangent_is_the_default_route():
    """osc_probs and prob3 take the multitangent route by default, so a
    direct caller of the Function runs what the stage runs."""
    import inspect

    from pisa_tpu_torch.stages.osc.prob3 import prob3

    for fn in (chain.osc_probs, prob3.__init__):
        default = inspect.signature(fn).parameters["multitangent"].default
        assert default is True, fn


def test_tangent_wrappers_reject_bad_inputs():
    e, dens, dist = _geometry(16)
    args = _layer_major(e, dens, dist)
    pvec, jac = _pack_and_jacobian(1)
    d = jac[:, 2].contiguous()
    with pytest.raises(ValueError, match="dpvec"):
        chain.chain_tangent(pvec, d.float(), *args)
    with pytest.raises(ValueError, match="dpvec"):
        chain.chain_tangent(pvec, d[:56], *args)
    with pytest.raises(ValueError, match="pvec"):
        chain.chain_tangent(pvec.float(), d, *args)
    with pytest.raises(ValueError, match="1..6"):
        chain.chain_multitangent(pvec, jac.T[:0].contiguous(), *args)
    with pytest.raises(ValueError, match="1..6"):
        chain.chain_multitangent(pvec, torch.cat([jac.T, jac.T[:1]]), *args)
    with pytest.raises(ValueError, match="1..6"):
        chain.chain_multitangent(pvec, d, *args)
    with pytest.raises(ValueError, match="nl"):
        chain.chain_multitangent(pvec, jac.T.contiguous(), *args[:3],
                                 args[3].long())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float64, 1e-9, 1e-10),
                                             (torch.float32, 1e-3, 1e-4)])
def test_tangent_kernels_match_reference_on_card(cuda_device, dtype, rtol,
                                                 atol):
    """The CUDA tangent (tile) and multitangent kernels against their plain
    versions on one card, on PREM-12 chains, with the launch counts rising
    by one per launch. Tangents relative to each direction's largest
    (float32: rounding, as in the primal's 1e-4 on probabilities <= 1)."""
    from pisa_tpu_torch.ops.osc.layers import Layers

    rng = np.random.RandomState(3)
    n = 4099
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    layers.calcLayers(rng.uniform(-1, 1, n))
    shape = (n, layers.max_layers)
    geom = chain.prepare_chain_geometry(
        10 ** rng.uniform(0, 3, n), layers.density.reshape(shape),
        layers.distance.reshape(shape), dtype=dtype, device=cuda_device,
    )
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    for nubar in (1, -1):
        pvec, jac = _pack_and_jacobian(nubar)
        pvec = pvec.to(cuda_device, dtype)
        dirs = jac.T.contiguous().to(cuda_device, dtype)
        before = chain.tangent_launch_count
        got = torch.stack([chain.chain_tangent(pvec, d, *args, geom["tiles"])
                           for d in dirs])
        assert chain.tangent_launch_count == before + 6
        want = torch.stack(
            [chain.chain_tangent_reference(pvec, d, *args) for d in dirs])
        torch.cuda.synchronize()
        assert _rel_err_per_direction(got.cpu(), want.cpu()).max() <= rtol

        dpvecs = dirs[list(FREE)].contiguous()
        before = chain.multitangent_launch_count
        p2, dp2 = chain.chain_multitangent(pvec, dpvecs, *args,
                                           geom["tiles"])
        assert chain.multitangent_launch_count == before + 1
        want_p, want_t = chain.chain_multitangent_reference(pvec, dpvecs,
                                                            *args)
        torch.cuda.synchronize()
        assert float((p2 - want_p).abs().max()) <= atol
        assert _rel_err_per_direction(dp2.cpu(), want_t.cpu()).max() <= rtol
