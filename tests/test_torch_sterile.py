"""
The port's 3+1 engine (``pisa_tpu_torch/ops/osc/sterile.py``) and its
eigenvalue routine (``ops/osc/herm4.py``) against the JAX package's
``pisa_tpu/ops/osc/sterile.py``, in fp64 on the CPU (conftest), where the
eigenvalues come from the kernel's plain version.

Tolerances: the mixing matrix to 1e-14 and the probabilities to 1e-10
(the same formulas; the eigenvalues from another algorithm, whose round-off
the deflated projectors divide by the cluster gaps); gradients and forward
Jacobians to 1e-7 relative with an absolute floor of 1e-9 of their largest
entry; near the mu/tau degeneracy the gradient against central differences
(step 1e-6) to 1e-6; lanes equal to their solo evaluations to 1e-14 (the same ops, in
another batch layout); the float32 row sums at the resonance within 2e-5,
the JAX package's own bound (tests/test_sterile.py:304-341).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pisa_tpu.ops.cplx import to_numpy
from pisa_tpu.ops.osc import sterile as J
from pisa_tpu_torch.ops.osc import herm4
from pisa_tpu_torch.ops.osc import sterile as T
from pisa_tpu_torch.ops.osc.layers import Layers

PROB_ATOL = 1e-10
MIX_ATOL = 1e-14
GRAD_RTOL = 1e-7
GRAD_ATOL_FRACTION = 1e-9
LANES_ATOL = 1e-14
FP32_ROW_SUM = 2e-5

TH12, TH13, TH23 = 0.5839, 0.1496, 0.7854
DM21, DM31 = 7.42e-5, 2.514e-3
#: (theta14, theta24, theta34, dcp13, dcp14, dcp24, dm41): two sterile points
POINTS = {
    "deepcore": (0.0, 0.1396, 0.05, 0.0, 0.0, 0.0, 1.0),
    "cp": (0.15, 0.2, 0.1, 1.2, 0.6, -0.4, 1.3),
}
LOWPASS = 0.04  # 1/km, sterile_example.cfg's cutoff


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's CPU ops on one thread: the test workers share the cores, and
    more threads each only contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _angles(point, th23=TH23):
    t14, t24, t34, d13, d14, d24, _ = POINTS[point]
    return (TH12, TH13, th23, t14, t24, t34, d13, d14, d24)


def _dms(point):
    return np.array([0.0, DM21, DM31, POINTS[point][-1]])


@pytest.fixture(scope="module")
def chains():
    """PREM-12 chains: seeded random points (1 GeV - 3 TeV) and the
    resonance set of tests/test_sterile.py:304 (coszen -1..-0.3 at 100,
    500 and 2000 GeV)."""
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    rng = np.random.RandomState(11)
    cz = np.concatenate([rng.uniform(-1, 1, 24),
                         np.tile(np.linspace(-1.0, -0.3, 8), 3)])
    energy = np.concatenate([10 ** rng.uniform(0, 3.5, 24),
                             np.repeat([100.0, 500.0, 2000.0], 8)])
    layers.calcLayers(cz)
    shape = (cz.size, layers.max_layers)
    return (energy, layers.density.reshape(shape),
            layers.density_neutron_weighted.reshape(shape),
            layers.distance.reshape(shape))


def _jax_probs(point, nubar, chains, lowpass):
    return np.asarray(J.osc_probs_layers_4nu(
        _dms(point), J.pmns4_matrix(*_angles(point)), nubar, *chains,
        lowpass_cutoff=lowpass))


def _torch_probs(point, nubar, chains, lowpass):
    return T.osc_probs_layers_4nu(
        torch.as_tensor(_dms(point)), T.pmns4_matrix(*_angles(point)), nubar,
        torch.as_tensor(chains[0]), *chains[1:],
        lowpass_cutoff=lowpass).numpy()


@pytest.mark.parametrize("point", sorted(POINTS))
def test_pmns4_matches_jax(point):
    want = to_numpy(J.pmns4_matrix(*_angles(point)))
    got = T.pmns4_matrix(*_angles(point)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MIX_ATOL)
    np.testing.assert_allclose(got @ np.conj(got.T), np.eye(4), atol=MIX_ATOL)


@pytest.mark.parametrize("lowpass", [0.0, LOWPASS],
                         ids=["amplitude", "lowpass"])
@pytest.mark.parametrize("nubar", [1, -1], ids=["nu", "nubar"])
def test_osc_probs_layers_4nu_matches_jax(chains, nubar, lowpass):
    """Both sterile points through one JAX compile per sign and picture."""
    for point in sorted(POINTS):
        want = _jax_probs(point, nubar, chains, lowpass)
        got = _torch_probs(point, nubar, chains, lowpass)
        assert got.shape == want.shape == (chains[0].size, 4, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL,
                                   err_msg=point)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-10)


def test_zero_length_slots_anywhere(chains):
    """A zero-length slot inside a chain is the identity, as in the JAX
    package, wherever it sits (the geometry moves the real slots to the
    front)."""
    energy, dens, dens_n, dist = chains
    gap = lambda x: np.concatenate([x[:, :2], np.zeros_like(x[:, :1]),
                                    x[:, 2:]], axis=1)
    want = _jax_probs("cp", 1, (energy, gap(dens), gap(dens_n), gap(dist)),
                      LOWPASS)
    got = _torch_probs("cp", 1, chains, LOWPASS)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def _resonance_row_sums(nubar, device):
    """tests/test_sterile.py:304-341 in float32 through the port on
    `device`: the deflated projectors and the Newton-Schulz step keep every
    row sum within 2e-5 at the TeV resonance."""
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    cz = np.linspace(-1.0, -0.3, 8)
    layers.calcLayers(cz)
    n = int(np.max(layers.n_layers))
    dens = layers.density.reshape(len(cz), -1)[:, :n]
    dist = layers.distance.reshape(len(cz), -1)[:, :n]
    U = T.pmns4_matrix(TH12, TH13, TH23, 0.12, 0.15, 0.0, 1.2, 0.0, 0.0,
                       device=device)
    dms = torch.tensor([0.0, DM21, DM31, 1.0], dtype=torch.float64,
                       device=device)
    for energy in (100.0, 500.0, 2000.0):
        e = torch.full((len(cz),), energy, dtype=torch.float32, device=device)
        p = T.osc_probs_layers_4nu(dms, U, nubar, e, dens, dens * 0.468,
                                   dist).cpu().numpy()
        assert p.dtype == np.float32
        np.testing.assert_allclose(p.sum(axis=2), 1.0, atol=FP32_ROW_SUM,
                                   err_msg=f"E={energy}")
        assert p.min() > -FP32_ROW_SUM


@pytest.mark.parametrize("nubar", [1, -1], ids=["nu", "nubar"])
def test_float32_resonance_row_sums(nubar):
    """With the kernel's plain version for the eigenvalues."""
    _resonance_row_sums(nubar, "cpu")


# -- derivatives ----------------------------------------------------------------
_FREE = ("theta23", "theta24", "theta34", "deltam41")


def _jax_fn(chains, nubar, lowpass):
    base = POINTS["cp"]

    def f(x):
        U = J.pmns4_matrix(TH12, TH13, x[0], base[0], x[1], x[2], base[3],
                           base[4], base[5])
        dms = jnp.stack([jnp.zeros(()), jnp.asarray(DM21), jnp.asarray(DM31),
                         x[3]])
        return J.osc_probs_layers_4nu(dms, U, nubar, *chains,
                                      lowpass_cutoff=lowpass)

    return f


def _torch_fn(geom, nubar, lowpass):
    base = POINTS["cp"]

    def f(x):
        U = T.pmns4_matrix(TH12, TH13, x[0], base[0], x[1], x[2], base[3],
                           base[4], base[5])
        dms = torch.stack([torch.zeros((), dtype=x.dtype),
                           torch.full((), DM21, dtype=x.dtype),
                           torch.full((), DM31, dtype=x.dtype), x[3]])
        return T.propagate_4nu(dms, U, nubar, geom, lowpass_cutoff=lowpass)

    return f


def _geom(chains):
    return T.prepare_4nu_geometry(*chains, dtype=torch.float64, device="cpu")


X0 = np.array([TH23, POINTS["cp"][1], POINTS["cp"][2], POINTS["cp"][-1]])
#: the probabilities weighted into one number, for the gradients
_WEIGHTS = np.random.RandomState(2).uniform(0.5, 1.5, (4, 4))


def _close(got, want, label):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRACTION * scale, err_msg=label)


@pytest.mark.parametrize("lowpass,nubar", [(0.0, 1), (LOWPASS, -1)],
                         ids=["amplitude-nu", "lowpass-nubar"])
def test_derivatives_match_jax(chains, lowpass, nubar):
    """In theta23, theta24, theta34 and dm41: torch.func.jacfwd (the Fisher
    matrices' route, through the eigenvalue Function's jvp and vmap rules)
    against jax.jacfwd, and reverse mode (autograd) of the weighted
    probabilities against the JAX Jacobian contracted with the same
    weights, which is jax.grad of that sum (one JAX compile for both)."""
    want = np.asarray(jax.jacfwd(_jax_fn(chains, nubar, lowpass))(
        jnp.asarray(X0)))
    geom = _geom(chains)
    got = torch.func.jacfwd(_torch_fn(geom, nubar, lowpass))(
        torch.tensor(X0)).numpy()
    assert got.shape == (chains[0].size, 4, 4, len(_FREE))
    for i, name in enumerate(_FREE):
        _close(got[..., i], want[..., i], name)
    x = torch.tensor(X0, requires_grad=True)
    (_torch_fn(geom, nubar, lowpass)(x) * torch.as_tensor(
        _WEIGHTS)).sum().backward()
    want_grad = np.einsum("nabi,ab->i", want, _WEIGHTS)
    assert np.all(want_grad != 0.0)
    _close(x.grad.numpy(), want_grad, "grad")


def test_gradient_finite_near_the_mu_tau_degeneracy():
    """At 20-100 TeV the mu/tau pair of the active cluster nearly coincides;
    only eigenvalue derivatives are taken, so the gradient stays finite, and
    it matches central differences of the probabilities (smooth there:
    the projectors of a pair sum to a smooth function)."""
    layers = Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    cz = np.array([-0.95, -0.6, -0.2])
    layers.calcLayers(np.repeat(cz, 2))
    shape = (6, layers.max_layers)
    chains = (np.tile([2e4, 1e5], 3), layers.density.reshape(shape),
              layers.density_neutron_weighted.reshape(shape),
              layers.distance.reshape(shape))
    geom = _geom(chains)
    U = T.pmns4_matrix(TH12, TH13, TH23, 0.0, 0.1, 0.0)
    h = T._layer_phase_and_projectors(
        U, torch.tensor(_dms("deepcore")), 1, geom["e"], geom["rho_e"],
        geom["rho_n"], geom["dist"])[1]
    gaps = torch.diff(h.sort(-1).values, dim=-1) / h.abs().amax(-1,
                                                                keepdim=True)
    assert float(gaps.min()) < 1e-4  # a nearly degenerate pair
    weights = torch.as_tensor(_WEIGHTS)
    for lowpass in (0.0, LOWPASS):
        f = _torch_fn(geom, 1, lowpass)
        x = torch.tensor(X0, requires_grad=True)
        (f(x) * weights).sum().backward()
        assert np.all(np.isfinite(x.grad.numpy()))
        step = 1e-6
        fd = [float(((f(torch.tensor(X0 + step * e)) - f(torch.tensor(
            X0 - step * e))) * weights).sum()) / (2 * step)
              for e in np.eye(len(X0))]
        np.testing.assert_allclose(x.grad.numpy(), fd, rtol=1e-6,
                                   atol=1e-6 * np.abs(fd).max(),
                                   err_msg=f"lowpass={lowpass}")


# -- lanes ------------------------------------------------------------------------
@pytest.mark.parametrize("lowpass", [0.0, LOWPASS],
                         ids=["amplitude", "lowpass"])
def test_lanes_equal_solo(chains, lowpass):
    """(B, 4) splittings and (B, 4, 4) mixing matrices give each lane's solo
    result; torch.func.vmap over points runs them as the same lanes."""
    geom = _geom(chains)
    pts = sorted(POINTS)
    lanes = [torch.tensor(np.stack([_angles(p)[k] for p in pts]))
             for k in range(9)]
    U = T.pmns4_matrix(*lanes, lanes=len(pts))
    dms = torch.as_tensor(np.stack([_dms(p) for p in pts]))
    got = T.propagate_4nu(dms, U, -1, geom, lowpass_cutoff=lowpass)
    for i, p in enumerate(pts):
        solo = T.propagate_4nu(torch.as_tensor(_dms(p)),
                               T.pmns4_matrix(*_angles(p)), -1, geom,
                               lowpass_cutoff=lowpass)
        np.testing.assert_allclose(got[i].numpy(), solo.numpy(), rtol=0,
                                   atol=LANES_ATOL, err_msg=p)
    mapped = torch.func.vmap(
        lambda d, u: T.propagate_4nu(d, u, -1, geom, lowpass_cutoff=lowpass)
    )(dms, U)
    np.testing.assert_allclose(mapped.numpy(), got.numpy(), rtol=0,
                               atol=LANES_ATOL)


# -- the eigenvalue Function ----------------------------------------------------
def _herm_from(x):
    """Hermitian (4, 4) matrices from (..., 16) real parameters: 4 diagonal,
    6 real and 6 imaginary upper entries, built by stacking (no in-place
    writes, so every transform runs through)."""
    d, r, i = x[..., :4], x[..., 4:10], x[..., 10:16]
    zero = torch.zeros_like(d[..., 0])
    rows, k, entries = [], 0, {}
    for a in range(4):
        for b in range(a + 1, 4):
            entries[(a, b)] = torch.complex(r[..., k], i[..., k])
            entries[(b, a)] = torch.complex(r[..., k], -i[..., k])
            k += 1
    for a in range(4):
        rows.append(torch.stack([
            torch.complex(d[..., a], zero) if a == b else entries[(a, b)]
            for b in range(4)], dim=-1))
    return torch.stack(rows, dim=-2)


def test_eigvalsh4_rules_on_the_cpu():
    """The Function's backward, jvp and vmap rules (the kernel's
    eigenvectors replaced by the plain version's here) against torch's own
    eigvalsh derivatives and finite differences (gradcheck, both modes)."""
    rng = np.random.RandomState(9)
    x = torch.tensor(rng.normal(size=(5, 16)), requires_grad=True)
    w = herm4.eigvalsh4(_herm_from(x))
    ref = torch.linalg.eigvalsh(_herm_from(x))
    np.testing.assert_allclose(w.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=1e-13)
    g = torch.as_tensor(rng.normal(size=(5, 4)))
    got = torch.autograd.grad((w * g).sum(), x)[0]
    want = torch.autograd.grad((ref * g).sum(), x)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    d = torch.as_tensor(rng.normal(size=(5, 16)))
    _, jvp = torch.func.jvp(lambda y: herm4.eigvalsh4(_herm_from(y)),
                            (x.detach(),), (d,))
    _, jvp_ref = torch.func.jvp(lambda y: torch.linalg.eigvalsh(_herm_from(y)),
                                (x.detach(),), (d,))
    np.testing.assert_allclose(jvp.numpy(), jvp_ref.numpy(), rtol=0,
                               atol=1e-12)
    jac = torch.func.jacfwd(lambda y: herm4.eigvalsh4(_herm_from(y)))(
        x.detach()[0])
    jac_rev = torch.func.jacrev(lambda y: herm4.eigvalsh4(_herm_from(y)))(
        x.detach()[0])
    np.testing.assert_allclose(jac.numpy(), jac_rev.numpy(), rtol=0,
                               atol=1e-12)
    mapped = torch.func.vmap(lambda y: herm4.eigvalsh4(_herm_from(y)))(
        x.detach())
    np.testing.assert_allclose(mapped.numpy(), w.detach().numpy(), rtol=0,
                               atol=1e-14)
    assert torch.autograd.gradcheck(
        lambda y: herm4.eigvalsh4(_herm_from(y)), (x[:2],),
        check_forward_ad=True)


def test_herm4_eig_plain_version_and_checks():
    rng = np.random.RandomState(3)
    a = rng.normal(size=(3, 2, 4, 4)) + 1j * rng.normal(size=(3, 2, 4, 4))
    H = torch.as_tensor(a)  # not Hermitian: its Hermitian part is taken
    w, V = herm4.herm4_eig(H)
    herm = 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(herm), atol=1e-13)
    assert V.shape == (3, 2, 4, 4)
    with pytest.raises(ValueError, match="complex64/complex128"):
        herm4.herm4_eig(H.real)
    with pytest.raises(ValueError, match="CUDA kernel only"):
        herm4.herm4_eig(H, sweeps=True)
    assert herm4.herm4_operations([4, 16]) == (61 + 31 * 5 + 846 * 4) + (
        61 + 31 * 16 + 846 * 16)


# -- on a card ------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_kernel_matches_plain_version_on_the_card(cuda_device, dtype):
    rng = np.random.RandomState(5)
    a = rng.normal(size=(4096, 4, 4)) + 1j * rng.normal(size=(4096, 4, 4))
    H = torch.as_tensor(0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))).to(dtype)
    before = herm4.launch_count
    w, V = herm4.herm4_eig(H.to(cuda_device))
    assert herm4.launch_count == before + 1
    want = np.linalg.eigvalsh(H.to(torch.complex128).numpy())
    norm = np.linalg.norm(H.to(torch.complex128).numpy(), axis=(-2, -1))
    tol = 1e-12 if dtype == torch.complex128 else 1e-5
    np.testing.assert_array_less(
        np.abs(w.cpu().double().numpy() - want).max(-1) / norm, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("nubar", [1, -1], ids=["nu", "nubar"])
def test_float32_resonance_row_sums_on_the_card(cuda_device, nubar):
    """With the kernel for the eigenvalues."""
    _resonance_row_sums(nubar, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("lowpass", [0.0, LOWPASS],
                         ids=["amplitude", "lowpass"])
def test_engine_on_the_card_matches_the_cpu(cuda_device, chains, lowpass):
    want = _torch_probs("cp", 1, chains, lowpass)
    got = T.osc_probs_layers_4nu(
        torch.as_tensor(_dms("cp")).to(cuda_device),
        T.pmns4_matrix(*_angles("cp"), device=cuda_device), 1,
        torch.as_tensor(chains[0]).to(cuda_device), *chains[1:],
        lowpass_cutoff=lowpass).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)
