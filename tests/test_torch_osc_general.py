"""
The port's general oscillation formulation (``pisa_tpu_torch/ops/osc/
kernels.py``), its non-standard physics matrices (``ops/osc/nonstandard.
py``), the layer dedup and slot indices (``ops/osc/layers.py``) and the
general-pack route of ``ops/osc/chain.py`` against the JAX package and the
reference's float64 golden pickles, in fp64 on the CPU (conftest).

Tolerances: the golden pickles at ``tests/test_osc_golden.py``'s (atol
10 eps, rtol 400 eps, and its tighter or looser per-function bounds);
the port against the JAX package at 1e-12 (the same formulas in another
operation order) and the packs at 1e-14.
"""

import glob
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pisa_tpu.ops.cplx import C, to_numpy
from pisa_tpu.ops.osc import kernels as JK
from pisa_tpu.ops.osc import layers as jax_layers
from pisa_tpu.ops.osc import nonstandard as jax_ns
from pisa_tpu.ops.osc import pallas_chain
from pisa_tpu_torch.ops.osc import chain
from pisa_tpu_torch.ops.osc import kernels as TK
from pisa_tpu_torch.ops.osc import layers as torch_layers
from pisa_tpu_torch.ops.osc import nonstandard as torch_ns
from pisa_tpu_torch.ops.osc.pmns import dm_matrix, pmns_matrix

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "pisa_tpu", "resources", "osc", "numba_osc_tests_data",
)
EPS = np.finfo(np.float64).eps
ATOL = 10 * EPS
RTOL = 400 * EPS
RTOL_T = 1e-9
ATOL_T = 1e-12
PARITY = 1e-12  # port vs JAX package, fp64
PACK_ATOL = 1e-14


def _cases(prefix):
    """The golden cases of `prefix` in fp64 (file names only, so that
    collection reads no pickle)."""
    paths = sorted(glob.glob(f"{DATA_DIR}/{prefix}__*__f8.pkl"))
    return [os.path.basename(p).split("__")[1] for p in paths]


def _load(prefix, case):
    with open(f"{DATA_DIR}/{prefix}__{case}__f8.pkl", "rb") as f:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pickle.load(f)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _c(x):
    return _t(x, torch.complex128)


# -- golden pickles ---------------------------------------------------------------
@pytest.mark.parametrize("case", _cases("get_H_vac_hostfunc"))
def test_golden_get_H_vac(case):
    d = _load("get_H_vac_hostfunc", case)
    ours = TK.get_H_vac(_c(d["mix_nubar"]), _t(np.real(d["dm_vac_vac"]))).numpy()
    np.testing.assert_allclose(ours, d["H_vac"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", _cases("get_H_mat_hostfunc"))
def test_golden_get_H_mat(case):
    d = _load("get_H_mat_hostfunc", case)
    ours = TK.get_H_mat(float(d["rho"]), _c(d["mat_pot"]), int(d["nubar"]))
    np.testing.assert_allclose(ours.numpy(), d["H_mat"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", _cases("get_H_decay_hostfunc"))
def test_golden_get_H_decay(case):
    d = _load("get_H_decay_hostfunc", case)
    ours = TK.get_H_decay(_c(d["mix_nubar"]), _c(d["mat_decay"])).numpy()
    np.testing.assert_allclose(ours, d["H_decay"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", _cases("get_dms_hostfunc"))
def test_golden_get_dms(case):
    d = _load("get_dms_hostfunc", case)
    m = TK.get_dms(float(d["energy"]), _c(d["H_full"]),
                   _t(np.real(d["dm_vac_vac"]))).numpy()
    np.testing.assert_allclose(np.broadcast_to(m[:, None], (3, 3)),
                               d["dm_mat"].real, rtol=RTOL_T, atol=ATOL_T)
    np.testing.assert_allclose(m[:, None] - m[None, :], d["dm_mat_mat"].real,
                               rtol=RTOL_T, atol=ATOL_T)


@pytest.mark.parametrize("case", _cases("get_dms_numerical_hostfunc"))
def test_golden_get_dms_numerical_sets(case):
    """Cardano eigenvalues equal the reference's as a set (the order
    differs; the Barger amplitude is permutation-symmetric)."""
    d = _load("get_dms_numerical_hostfunc", case)
    ours = np.sort_complex(
        TK.get_dms_numerical(float(d["energy"]), _c(d["H_full"])).numpy())
    np.testing.assert_allclose(ours, np.sort_complex(np.diag(d["dm_mat"])),
                               rtol=10 * RTOL_T, atol=ATOL_T)


@pytest.mark.parametrize(
    "case", _cases("get_transition_matrix_massbasis_hostfunc"))
def test_golden_transition_matrix_massbasis(case):
    d = _load("get_transition_matrix_massbasis_hostfunc", case)
    m = [_c(mk) for mk in np.diag(d["dm_mat"])]
    h2e = _c(2.0 * float(d["energy"]) * d["H_full_mass_eigenstate_basis"])
    ours = TK._transition(float(d["baseline"]), float(d["energy"]), m, h2e)
    np.testing.assert_allclose(ours.numpy(), d["transition_matrix"],
                               rtol=RTOL_T, atol=ATOL_T)


@pytest.mark.parametrize("case", _cases("get_transition_matrix_hostfunc"))
def test_golden_get_transition_matrix(case):
    d = _load("get_transition_matrix_hostfunc", case)
    ours = TK.get_transition_matrix(
        int(d["nubar"]), float(d["energy"]), float(d["rho"]),
        float(d["baseline"]), _c(d["mix_nubar"]), _c(d["mat_pot"]),
        _c(d["H_vac"]), _c(d["H_decay"]), _t(np.real(d["lri_pot"])),
        _t(np.real(d["dm"])), decay_flag=int(d["decay_flag"]) == 1)
    np.testing.assert_allclose(ours.numpy(), d["transition_matrix"],
                               rtol=10 * RTOL_T, atol=10 * ATOL_T)


def _propagate(d, decay=None):
    decay = int(d["decay_flag"]) == 1 if decay is None else decay
    return TK.propagate_grid(
        np.real(d["dm"]), d["mix"], d["mat_pot"], d["mat_decay"],
        np.real(d["lri_pot"]), int(d["nubar"]),
        np.atleast_1d(np.float64(d["energy"])), d["densities"][None, :],
        d["distances"][None, :], decay_flag=decay)[0]


@pytest.mark.parametrize("case", _cases("propagate_scalar"))
def test_golden_propagate(case):
    """End-to-end probabilities through the full layer chain, every physics
    case (standard, NSI, decay, LRI, tomography)."""
    d = _load("propagate_scalar", case)
    np.testing.assert_allclose(_propagate(d), d["probability"],
                               rtol=10 * RTOL_T, atol=10 * ATOL_T)


@pytest.mark.parametrize("case", _cases("propagate_scalar"))
def test_golden_propagate_unitarity(case):
    """Without decay, rows sum to 1; with decay, to less (nu3 decays), and
    to 1 again at alpha3 = 0."""
    d = _load("propagate_scalar", case)
    if int(d["decay_flag"]) == 1:
        assert np.all(_propagate(d).sum(axis=1) < 1.0)
        d = dict(d, mat_decay=np.zeros((3, 3), complex))
    np.testing.assert_allclose(_propagate(d).sum(axis=1), 1.0, atol=1e-10)


# -- random inputs against the JAX package ------------------------------------------
@pytest.fixture(scope="module")
def random_inputs():
    """Seeded NSI, decay and LRI physics over 40 Earth chains."""
    rng = np.random.RandomState(11)
    theta = [0.58, 0.15, 0.8, 3.5]
    mix = pmns_matrix(*(torch.sin(_t(x)) for x in theta[:3]), _t(theta[3]))
    dm = dm_matrix(_t(7.4e-5), _t(2.5e-3))
    lay = torch_layers.Layers("osc/PREM_12layer.dat", 2.0, 20.0)
    lay.setElecFrac(0.4656, 0.4656, 0.4957)
    n = 40
    cz = rng.uniform(-1, 1, n)
    energy = 10 ** rng.uniform(0, 2, n)
    lay.calcLayers(cz)
    dens = lay.density.reshape(n, -1)
    dist = lay.distance.reshape(n, -1)
    eps = 0.1 * (rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3)))
    mat_pot = np.diag([1.0, 0.0, 0.0]) + eps + eps.conj().T
    mat_decay = np.zeros((3, 3), complex)
    mat_decay[2, 2] = -3e-4j
    lri = np.diag([0.0, 2e-14, -2e-14])
    return {"mix": mix.numpy(), "dm": dm.numpy(), "mat_pot": mat_pot,
            "mat_decay": mat_decay, "lri": lri, "energy": energy,
            "dens": dens, "dist": dist}


@pytest.mark.parametrize("layout", ["padded", "slots", "dedup"])
@pytest.mark.parametrize("decay", [False, True], ids=["nsi-lri", "decay"])
@pytest.mark.parametrize("nubar", [1, -1])
def test_osc_probs_layers_matches_jax(random_inputs, layout, decay, nubar):
    r = random_inputs
    U = r["mix"] if nubar > 0 else r["mix"].conj()
    dens, dist = r["dens"], r["dist"]
    kwargs, tkwargs = {}, {}
    if layout == "slots":
        si = torch_layers.layer_slot_index(dist)
        kwargs["slot_index"] = si
        tkwargs["slot_index"] = torch.as_tensor(si, dtype=torch.int64)
    elif layout == "dedup":
        dens, dist, cm = torch_layers.dedup_layers(dens, dist)
        kwargs["chain_map"] = cm
        tkwargs["chain_map"] = torch.as_tensor(cm)
    want = np.asarray(JK._osc_probs_xla(
        r["dm"], C.of(U), C.of(r["mat_pot"]), C.of(r["mat_decay"]), r["lri"],
        nubar, r["energy"], dens, dist, decay_flag=decay, **kwargs))
    got = TK.osc_probs_layers(
        _t(r["dm"]), _c(r["mix"]), _c(r["mat_pot"]), _c(r["mat_decay"]),
        _t(r["lri"]), nubar, _t(r["energy"]), _t(dens), _t(dist),
        decay_flag=decay, **tkwargs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PARITY)


def test_slot_index_is_checked(random_inputs):
    r = random_inputs
    si = torch.as_tensor(torch_layers.layer_slot_index(r["dist"]),
                         dtype=torch.int64)
    args = (_t(r["dm"]), _c(r["mix"]), _c(r["mat_pot"]), None, _t(r["lri"]),
            1, _t(r["energy"]), _t(r["dens"]), _t(r["dist"]))
    with pytest.raises(ValueError, match="slot_index inconsistent"):
        TK.osc_probs_layers(*args, slot_index=si[1:])
    with pytest.raises(ValueError, match="contents differ"):
        TK.osc_probs_layers(*args, slot_index=si.flip(0))


# -- matrices, layers -------------------------------------------------------------
NSI_STD = (0.2, 0.05, 0.3, 0.07, -1.1, -0.1, 0.12, 2.0, 0.15)
NSI_VAC = (1.3, 0.4, 0.3, -0.2, 0.9, 0.5, -0.7, 1.9)


@pytest.mark.parametrize("kind", ["standard", "vacuum-like", "decay",
                                  "emu-symmetry", "etau-symmetry",
                                  "mutau-symmetry"])
def test_matrices_match_jax(kind):
    if kind == "standard":
        want = to_numpy(jax_ns.std_nsi_eps_C(*NSI_STD))
        got = torch_ns.std_nsi_eps(*NSI_STD)
        cls = jax_ns.StdNSIParams()
        cls.eps_ee, cls.eps_mumu, cls.eps_tautau = (NSI_STD[0], NSI_STD[5],
                                                    NSI_STD[8])
        cls.eps_emu = NSI_STD[1:3]
        cls.eps_etau = NSI_STD[3:5]
        cls.eps_mutau = NSI_STD[6:8]
        port = torch_ns.StdNSIParams()
        port.eps_ee, port.eps_mumu, port.eps_tautau = (NSI_STD[0], NSI_STD[5],
                                                       NSI_STD[8])
        port.eps_emu = NSI_STD[1:3]
        port.eps_etau = NSI_STD[3:5]
        port.eps_mutau = NSI_STD[6:8]
        np.testing.assert_allclose(port.eps_matrix, cls.eps_matrix, atol=0)
        np.testing.assert_allclose(got.numpy(), port.eps_matrix, atol=1e-15)
    elif kind == "vacuum-like":
        want = to_numpy(jax_ns.vacuum_nsi_eps_C(*NSI_VAC))
        got = torch_ns.vacuum_nsi_eps(*NSI_VAC)
        port = torch_ns.VacuumLikeNSIParams()
        (port.eps_scale, port.eps_prime, port.phi12, port.phi13, port.phi23,
         port.alpha1, port.alpha2, port.deltansi) = NSI_VAC
        np.testing.assert_allclose(got.numpy(), port.eps_matrix, atol=1e-14)
    elif kind == "decay":
        want = to_numpy(jax_ns.decay_matrix_C(2.5e-4))
        got = torch_ns.decay_matrix(2.5e-4)
        port = torch_ns.DecayParams()
        port.decay_alpha3 = 2.5e-4
        np.testing.assert_array_equal(got.numpy(), port.decay_matrix)
    else:
        want = np.asarray(jax_ns.lri_potential(3e-14, kind))
        got = torch_ns.lri_potential(3e-14, kind)
        port = torch_ns.LRIParams()
        port.v_lri = 3e-14
        name = "potential_matrix_" + kind.split("-")[0]
        np.testing.assert_array_equal(got.numpy(), getattr(port, name))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


def test_matrix_functions_take_tensors_and_differentiate():
    """A coupling given as a 0-d tensor keeps its graph: d eps / d
    eps_mutau_magn is exp(i phase) at [1, 2] (and its conjugate at [2, 1])."""
    magn = torch.tensor(0.12, dtype=torch.float64, requires_grad=True)
    args = list(NSI_STD)
    args[6] = magn
    eps = torch_ns.std_nsi_eps(*args)
    (g,) = torch.autograd.grad(eps[1, 2].real, magn)
    assert abs(float(g) - np.cos(NSI_STD[7])) < 1e-15
    v = torch.tensor(1e-14, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(
        torch_ns.lri_potential(v, "mutau-symmetry")[2, 2], v)
    assert float(g) == -1.0


@pytest.mark.parametrize("kind", ["w_constrain", "wo_constrain", "mass"])
def test_tomography_scalings_match_jax(kind):
    if kind == "w_constrain":
        a, b = jax_ns.Core_scaling_w_constrain(), torch_ns.Core_scaling_w_constrain()
        a.core_density_scale = b.core_density_scale = 1.05
        np.testing.assert_array_equal(a.scaling_array, b.scaling_array)
    elif kind == "wo_constrain":
        a = jax_ns.Core_scaling_wo_constrain()
        b = torch_ns.Core_scaling_wo_constrain()
        for x in (a, b):
            (x.core_density_scale, x.innermantle_density_scale,
             x.middlemantle_density_scale) = (1.1, 0.9, 1.02)
        np.testing.assert_array_equal(a.scaling_factor_array,
                                      b.scaling_factor_array)
    else:
        b = torch_ns.Mass_scaling()
        b.density_scale = 1.2
        assert b.density_scale == 1.2
        with pytest.raises(AssertionError):
            b.density_scale = -1.0
    np.testing.assert_array_equal(torch_ns.FIVE_LAYER_RADII_KM,
                                  jax_ns.FIVE_LAYER_RADII_KM)
    np.testing.assert_array_equal(torch_ns.FIVE_LAYER_RHOS,
                                  jax_ns.FIVE_LAYER_RHOS)
    assert torch_ns.TOMOGRAPHY_ERROR_MSG == jax_ns.TOMOGRAPHY_ERROR_MSG


def test_dedup_and_slot_index_match_jax(random_inputs):
    r = random_inputs
    for want, got in zip(jax_layers.dedup_layers(r["dens"], r["dist"]),
                         torch_layers.dedup_layers(r["dens"], r["dist"])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(torch_layers.layer_slot_index(r["dist"]),
                                  jax_layers.layer_slot_index(r["dist"]))


# -- the general-pack route ------------------------------------------------------------
@pytest.mark.parametrize("nubar", [1, -1])
def test_pack_from_physics_matches_jax(random_inputs, nubar):
    r = random_inputs
    U = r["mix"] if nubar > 0 else r["mix"].conj()
    want = np.asarray(pallas_chain._pack_from_physics(
        r["dm"], C.of(U), C.of(r["mat_pot"]), r["lri"], nubar,
        jnp.float64)).reshape(-1)
    got = chain.pack_from_physics(_t(r["dm"]), _c(U), _c(r["mat_pot"]),
                                  _t(r["lri"]), nubar)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PACK_ATOL)


@pytest.mark.parametrize("nubar", [1, -1])
def test_plain_primal_at_general_packs_matches_pallas(random_inputs, nubar):
    """The primal kernel's plain version at an NSI+LRI pack (complex
    off-diagonal M_eff, nonzero L_eff) against the Pallas kernel run in
    interpret mode (whose atan polynomial has max error 1.8e-9,
    pallas_chain.py:116-117, hence atol 1e-6, as test_torch_chain.py's
    standard packs) and against the JAX package's XLA formulation (1e-12)."""
    r = random_inputs
    U = r["mix"] if nubar > 0 else r["mix"].conj()
    pvec = pallas_chain._pack_from_physics(
        r["dm"], C.of(U), C.of(r["mat_pot"]), r["lri"], nubar, jnp.float64)
    want = np.asarray(pallas_chain.chain_probs_pallas(
        pvec, jnp.asarray(r["energy"]), jnp.asarray(r["dens"]),
        jnp.asarray(r["dist"]), interpret=True))
    geom = chain.prepare_chain_geometry(r["energy"], r["dens"], r["dist"],
                                        dtype=torch.float64, device="cpu")
    got = chain.osc_probs_prepared(_t(np.asarray(pvec).reshape(-1)), geom)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    xla = np.asarray(JK._osc_probs_xla(
        r["dm"], C.of(U), C.of(r["mat_pot"]), None, r["lri"], nubar,
        r["energy"], r["dens"], r["dist"]))
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=PARITY)


def _physics(couplings):
    """(dm, mix, mat_pot, lri_pot) with eps_mutau_magn and v_lri taken from
    the 0-d tensors in `couplings`, on their device."""
    magn, v_lri = couplings
    device = magn.device
    theta = [0.58, 0.15, 0.8, 3.5]

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    mix = pmns_matrix(*(torch.sin(t(x)) for x in theta[:3]), t(theta[3]))
    dm = dm_matrix(t(7.4e-5), t(2.5e-3))
    args = list(NSI_STD)
    args[6] = magn
    mat_pot = torch.zeros((3, 3), dtype=torch.complex128, device=device)
    mat_pot[0, 0] = 1.0
    mat_pot = mat_pot + torch_ns.std_nsi_eps(*args)
    return dm, mix, mat_pot, torch_ns.lri_potential(v_lri, "emu-symmetry")


@pytest.mark.parametrize("nubar", [1, -1])
def test_general_route_value_and_gradient(random_inputs, nubar):
    """osc_probs_general (the primal's plain version forward, the general
    formulation's reverse mode over the sorted real slots backward) against
    the general formulation run directly on the unsorted chains: value, and
    the gradient of a weighted sum in eps_mutau_magn and v_lri, which also
    agrees with central differences."""
    r = random_inputs
    geom = chain.prepare_chain_geometry(r["energy"], r["dens"], r["dist"],
                                        dtype=torch.float64, device="cpu",
                                        general=True)
    weights = _t(np.random.RandomState(3).uniform(size=(len(r["energy"]), 3, 3)))

    def value(route, couplings):
        dm, mix, mat_pot, lri = _physics(couplings)
        if route == "general":
            probs = chain.osc_probs_general(dm, mix, mat_pot, lri, nubar, geom)
        else:
            probs = TK.osc_probs_layers(dm, mix, mat_pot, None, lri, nubar,
                                        _t(r["energy"]), _t(r["dens"]),
                                        _t(r["dist"]))
        return (probs * weights).sum()

    results = {}
    for route in ("general", "layers"):
        couplings = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
                     for x in (0.12, 3e-14)]
        v = value(route, couplings)
        results[route] = (float(v), torch.autograd.grad(v, couplings))
    np.testing.assert_allclose(results["general"][0], results["layers"][0],
                               rtol=1e-13)
    for a, b in zip(*(results[k][1] for k in ("general", "layers"))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-9)
    for i, h in enumerate((1e-6, 1e-20)):
        up = [_t(0.12), _t(3e-14)]
        down = [_t(0.12), _t(3e-14)]
        up[i] = up[i] + h
        down[i] = down[i] - h
        fd = (float(value("general", up)) - float(value("general", down))) / (2 * h)
        np.testing.assert_allclose(float(results["general"][1][i]), fd,
                                   rtol=1e-5)


def test_general_route_needs_the_general_geometry(random_inputs):
    """Only a geometry prepared with general=True carries the slot indices
    the general route's backward takes; another is refused up front."""
    r = random_inputs
    geom = chain.prepare_chain_geometry(r["energy"], r["dens"], r["dist"],
                                        dtype=torch.float64, device="cpu")
    assert "slot_index" not in geom
    dm, mix, mat_pot, lri = _physics((_t(0.1), _t(3e-14)))
    with pytest.raises(ValueError, match="general=True"):
        chain.osc_probs_general(dm, mix, mat_pot, lri, 1, geom)


def test_general_route_forward_mode_raises(random_inputs):
    """Forward mode through the general route no longer raises:
    ``torch.func.jacfwd`` in eps_mutau_magn and v_lri (the pack's tangents
    through the plain multitangent) equals ``torch.func.jacrev`` (the
    general formulation's reverse mode), within 1e-10 of the largest
    entry."""
    r = random_inputs
    geom = chain.prepare_chain_geometry(r["energy"], r["dens"], r["dist"],
                                        dtype=torch.float64, device="cpu",
                                        general=True)
    weights = _t(np.random.RandomState(4).normal(size=(3, len(r["energy"]),
                                                       3, 3)))

    def f(x):  # v_lri in units of 1e-14 eV: the columns are O(1)
        dm, mix, mat_pot, lri = _physics((x[0], x[1] * 1e-14))
        probs = chain.osc_probs_general(dm, mix, mat_pot, lri, 1, geom)
        return (weights * probs).sum(dim=(1, 2, 3))

    x = _t([0.1, 3.0])
    jac_f = torch.func.jacfwd(f)(x)
    jac_r = torch.func.jacrev(f)(x)
    assert jac_f.shape == (3, 2)
    scale = float(jac_r.abs().max())
    assert scale > 0
    assert float((jac_f - jac_r).abs().max()) <= 1e-10 * scale


# -- on the card ----------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("nubar", [1, -1])
def test_general_route_on_card(random_inputs, cuda_device, nubar):
    """osc_probs_general on the card (one primal launch forward, the general
    formulation backward) against the CPU in float64: probabilities within
    1e-10 (the kernel's bound), the couplings' gradients within 1e-9
    relative."""
    r = random_inputs
    weights = np.random.RandomState(3).uniform(size=(len(r["energy"]), 3, 3))
    results = {}
    for device in ("cpu", cuda_device):
        geom = chain.prepare_chain_geometry(r["energy"], r["dens"], r["dist"],
                                            dtype=torch.float64, device=device,
                                            general=True)
        couplings = [torch.tensor(x, dtype=torch.float64, device=device,
                                  requires_grad=True) for x in (0.12, 3e-14)]
        dm, mix, mat_pot, lri = _physics(couplings)
        before = chain.launch_count
        probs = chain.osc_probs_general(dm, mix, mat_pot, lri, nubar, geom)
        launched = chain.launch_count - before
        value = (probs * _t(weights).to(device)).sum()
        grads = torch.autograd.grad(value, couplings)
        results[str(device)] = (probs.detach().cpu().numpy(),
                                [float(g) for g in grads], launched)
    (want, want_g, cpu_launches), (got, got_g, launches) = results.values()
    assert (cpu_launches, launches) == (0, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-9)
