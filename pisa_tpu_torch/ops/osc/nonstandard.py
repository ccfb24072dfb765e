"""
Non-standard physics inputs of the prob3 stage: NSI couplings, neutrino
decay, long-range interactions, and Earth-tomography density scalings.

Counterpart of ``pisa_tpu/ops/osc/nonstandard.py`` (reference
``pisa/stages/osc/{nsi_params,decay_params,lri_params,scaling_params}.py``),
with the same math and conventions. The matrix functions (:func:`std_nsi_eps`,
:func:`vacuum_nsi_eps`, :func:`decay_matrix`, :func:`lri_potential`) return
complex (or, for the LRI potential, real) ``(3, 3)`` torch tensors; their
scalar inputs may be numbers or 0-d tensors that carry the autograd graph,
so a compiled template takes analytic gradients in the couplings, or lanes
of them ((B,) or (B, 1) tensors, the batched fits' magnitudes), which give
``(B, 3, 3)``. A number is filled in on the device of the first tensor input
(or on `device`), not copied from the host. Nothing is written in place
into an input's function, so ``torch.func.jacfwd`` and ``torch.func.vmap``
run through them (as the JAX package's functions run under ``vmap``).
The JAX package's split (re, im) ``C`` type is a TPU workaround and has no
counterpart here.

The numpy parameter classes and the tomography scalings are copies of the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "StdNSIParams",
    "VacuumLikeNSIParams",
    "DecayParams",
    "LRIParams",
    "std_nsi_eps",
    "vacuum_nsi_eps",
    "decay_matrix",
    "lri_potential",
    "Mass_scaling",
    "Core_scaling_w_constrain",
    "Core_scaling_wo_constrain",
    "FIVE_LAYER_RADII_KM",
    "FIVE_LAYER_RHOS",
    "TOMOGRAPHY_ERROR_MSG",
]


def _scalars(values, device=None):
    """`values` as float64 tensors of one shape on one device: () for one
    point, (B,) for lanes (a tensor of more than one element is one value
    per lane, a (B,) or (B, 1) magnitude). Tensors keep their graph,
    numbers are filled in on the device of the first tensor (or `device`,
    or the CPU) and spread over the lanes."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if device is None:
        device = tensors[0].device if tensors else "cpu"
    shape = ()
    for v in tensors:
        if v.dim() > 0:
            shape = (v.numel(),)
            break
    return [
        v.to(torch.float64).reshape(-1 if v.dim() > 0 else ()).expand(shape)
        if isinstance(v, torch.Tensor)
        else torch.full(shape, float(v), dtype=torch.float64, device=device)
        for v in values
    ]


def _matrix(rows):
    """A (..., 3, 3) tensor from a 3x3 nest of tensors of the lanes' shape."""
    return torch.stack([torch.stack(list(r), dim=-1) for r in rows], dim=-2)


def _cis(re_scale, angle):
    """re_scale * exp(i angle) as a 0-d complex tensor."""
    return torch.complex(re_scale * torch.cos(angle), re_scale * torch.sin(angle))


# ---------------------------------------------------------------------------
# Differentiable matrix functions
# ---------------------------------------------------------------------------
def std_nsi_eps(eps_ee, eps_emu_magn, eps_emu_phase, eps_etau_magn,
                eps_etau_phase, eps_mumu, eps_mutau_magn, eps_mutau_phase,
                eps_tautau, device=None):
    """Hermitian standard-parameterization eps matrix, complex (3, 3) (lanes:
    (B, 3, 3)), with
    the diagonal shifted by -eps_mumu (the trace is irrelevant), as
    ``StdNSIParams.eps_matrix`` (``nonstandard.py:44`` of the JAX
    package)."""
    (ee, emu_m, emu_p, etau_m, etau_p, mumu, mutau_m, mutau_p,
     tautau) = _scalars((eps_ee, eps_emu_magn, eps_emu_phase, eps_etau_magn,
                         eps_etau_phase, eps_mumu, eps_mutau_magn,
                         eps_mutau_phase, eps_tautau), device)
    z = torch.zeros_like(ee)
    emu_re, emu_im = emu_m * torch.cos(emu_p), emu_m * torch.sin(emu_p)
    etau_re, etau_im = etau_m * torch.cos(etau_p), etau_m * torch.sin(etau_p)
    mutau_re, mutau_im = (mutau_m * torch.cos(mutau_p),
                          mutau_m * torch.sin(mutau_p))
    re = _matrix([[ee - mumu, emu_re, etau_re],
                  [emu_re, z, mutau_re],
                  [etau_re, mutau_re, tautau - mumu]])
    im = _matrix([[z, emu_im, etau_im],
                  [-emu_im, z, mutau_im],
                  [-etau_im, -mutau_im, z]])
    return torch.complex(re, im)


def vacuum_nsi_eps(eps_scale, eps_prime, phi12, phi13, phi23, alpha1, alpha2,
                   deltansi, device=None):
    """Vacuum-like NSI eps matrix (JHEP08(2018)180), complex (3, 3) (lanes:
    (B, 3, 3)), with
    the diagonal shifted by the mumu entry and the standard CC term, as
    ``VacuumLikeNSIParams.eps_matrix`` (``nonstandard.py:75`` of the JAX
    package)."""
    (scale, prime, p12, p13, p23, a1, a2, dnsi) = _scalars(
        (eps_scale, eps_prime, phi12, phi13, phi23, alpha1, alpha2,
         deltansi), device)
    one = torch.ones_like(scale)
    zero = torch.zeros_like(scale)
    cz, c1 = torch.complex(zero, zero), torch.complex(one, zero)

    def cr(x):
        return torch.complex(x, zero)

    q = [_cis(one, a1), _cis(one, a2), _cis(one, -(a1 + a2))]
    Qrel = _matrix([[q[0], cz, cz], [cz, q[1], cz], [cz, cz, q[2]]])
    c12, s12 = torch.cos(p12), torch.sin(p12)
    c13, s13 = torch.cos(p13), torch.sin(p13)
    c23, s23 = torch.cos(p23), torch.sin(p23)
    R12 = _matrix([[cr(c12), cr(s12), cz], [cr(-s12), cr(c12), cz],
                   [cz, cz, c1]])
    R13 = _matrix([[cr(c13), cz, cr(s13)], [cz, c1, cz],
                   [cr(-s13), cz, cr(c13)]])
    R23 = _matrix([[c1, cz, cz],
                   [cz, cr(c23), _cis(s23, -dnsi)],
                   [cz, _cis(-s23, dnsi), cr(c23)]])
    D = _matrix([[cr(scale), cz, cz], [cz, cr(prime), cz], [cz, cz, cz]])
    U = R12 @ R13 @ R23
    full = (Qrel @ U @ D @ U.conj().transpose(-1, -2)
            @ Qrel.conj().transpose(-1, -2))
    # subtract the mumu entry from the diagonal, the CC term from ee, and
    # force real diagonals (Hermitian by construction up to roundoff)
    eye = torch.eye(3, dtype=torch.float64, device=scale.device)
    e00 = torch.zeros((3, 3), dtype=torch.float64, device=scale.device)
    e00[0, 0] = 1.0  # a constant, not a function of the couplings
    re = full.real - full.real[..., 1:2, 1:2] * eye - e00
    im = full.imag * (1.0 - eye)
    return torch.complex(re, im)


def decay_matrix(decay_alpha3, device=None):
    """Invisible-nu3-decay matrix, complex (3, 3) (lanes: (B, 3, 3)):
    -i*alpha3 at [2, 2]
    (``nonstandard.py:150`` of the JAX package)."""
    (alpha3,) = _scalars((decay_alpha3,), device)
    z = torch.zeros_like(alpha3)
    im = _matrix([[z, z, z], [z, z, z], [z, z, -alpha3]])
    return torch.complex(torch.zeros_like(im), im)


def lri_potential(v_lri, lri_type, device=None):
    """Long-range-interaction flavour potential, real diagonal (3, 3) (lanes:
    (B, 3, 3)), for the given symmetry; differentiable in `v_lri`
    (``nonstandard.py:157`` of the JAX package)."""
    (v,) = _scalars((v_lri,), device)
    z = torch.zeros_like(v)
    if lri_type == "emu-symmetry":
        d = (v, -v, z)
    elif lri_type == "etau-symmetry":
        d = (v, z, -v)
    elif lri_type == "mutau-symmetry":
        d = (z, v, -v)
    else:
        raise ValueError(f"unknown lri_type {lri_type!r}")
    return _matrix([[d[0], z, z], [z, d[1], z], [z, z, d[2]]])


# ---------------------------------------------------------------------------
# Parameter classes (numpy; the reference's API)
# ---------------------------------------------------------------------------
class StdNSIParams:
    """Standard-parameterization NSI: 3 real diagonal + 3 (magnitude, phase)
    off-diagonal couplings -> Hermitian eps matrix
    (cf. reference ``nsi_params.py`` ``StdNSIParams``)."""

    def __init__(self):
        self._m = np.zeros((3, 3), dtype=np.complex128)

    @staticmethod
    def _polar(value):
        magnitude, phase = value
        return magnitude * (np.cos(phase) + 1j * np.sin(phase))

    @property
    def eps_ee(self):
        return self._m[0, 0].real

    @eps_ee.setter
    def eps_ee(self, value):
        self._m[0, 0] = value

    @property
    def eps_mumu(self):
        return self._m[1, 1].real

    @eps_mumu.setter
    def eps_mumu(self, value):
        self._m[1, 1] = value

    @property
    def eps_tautau(self):
        return self._m[2, 2].real

    @eps_tautau.setter
    def eps_tautau(self, value):
        self._m[2, 2] = value

    @property
    def eps_emu(self):
        return self._m[0, 1]

    @eps_emu.setter
    def eps_emu(self, value):
        self._m[0, 1] = self._polar(value)
        self._m[1, 0] = np.conjugate(self._m[0, 1])

    @property
    def eps_etau(self):
        return self._m[0, 2]

    @eps_etau.setter
    def eps_etau(self, value):
        self._m[0, 2] = self._polar(value)
        self._m[2, 0] = np.conjugate(self._m[0, 2])

    @property
    def eps_mutau(self):
        return self._m[1, 2]

    @eps_mutau.setter
    def eps_mutau(self, value):
        self._m[1, 2] = self._polar(value)
        self._m[2, 1] = np.conjugate(self._m[1, 2])

    @property
    def eps_matrix(self):
        # trace is irrelevant: subtract the mumu entry from the diagonal
        m = self._m - self._m[1, 1] * np.eye(3)
        for i in range(3):
            m[i, i] = m[i, i].real
        return m


class VacuumLikeNSIParams:
    """Vacuum-like NSI parameterization (JHEP08(2018)180): eps matrix built
    from an eigenvalue scale/prime, three rotation angles, two Majorana-like
    phases, and an NSI phase (cf. reference ``nsi_params.py`` vacuum-like)."""

    def __init__(self):
        self.eps_scale = 1.0
        self.eps_prime = 0.0
        self.phi12 = 0.0
        self.phi13 = 0.0
        self.phi23 = 0.0
        self.alpha1 = 0.0
        self.alpha2 = 0.0
        self.deltansi = 0.0

    @property
    def eps_matrix(self):
        qdiag = np.array(
            [
                np.exp(1j * self.alpha1),
                np.exp(1j * self.alpha2),
                np.exp(-1j * (self.alpha1 + self.alpha2)),
            ]
        )
        Qrel = np.diag(qdiag)
        c12, s12 = np.cos(self.phi12), np.sin(self.phi12)
        c13, s13 = np.cos(self.phi13), np.sin(self.phi13)
        c23, s23 = np.cos(self.phi23), np.sin(self.phi23)
        R12 = np.array([[c12, s12, 0], [-s12, c12, 0], [0, 0, 1]])
        R13 = np.array([[c13, 0, s13], [0, 1, 0], [-s13, 0, c13]])
        R23 = np.array(
            [
                [1, 0, 0],
                [0, c23, s23 * np.exp(-1j * self.deltansi)],
                [0, -s23 * np.exp(1j * self.deltansi), c23],
            ]
        )
        Umat = R12 @ R13 @ R23
        Dmat = np.diag([self.eps_scale, self.eps_prime, 0.0])
        mat_pot = Qrel @ Umat @ Dmat @ Umat.conj().T @ Qrel.conj().T
        # trace is physically irrelevant: subtract the mumu entry, then the
        # standard CC matter term from the ee entry
        mat_pot = mat_pot - mat_pot[1, 1] * np.eye(3)
        mat_pot[0, 0] -= 1.0
        for i in range(3):
            mat_pot[i, i] = mat_pot[i, i].real
        return mat_pot


class DecayParams:
    """Invisible nu3 decay: alpha3 = m3/tau3 enters the vacuum Hamiltonian as
    -i*alpha3 in the [2,2] mass-basis entry (cf. reference
    ``decay_params.py``)."""

    def __init__(self):
        self.decay_alpha3 = 0.0

    @property
    def decay_matrix(self):
        m = np.zeros((3, 3), dtype=np.complex128)
        m[2, 2] = -1j * self.decay_alpha3
        return m


class LRIParams:
    """Long-range-interaction flavor potentials for the three anomaly-free
    U(1) symmetries (cf. reference ``lri_params.py``); ``v_lri`` in eV."""

    def __init__(self):
        self.v_lri = 0.0

    @property
    def potential_matrix_emu(self):
        return np.diag([self.v_lri, -self.v_lri, 0.0])

    @property
    def potential_matrix_etau(self):
        return np.diag([self.v_lri, 0.0, -self.v_lri])

    @property
    def potential_matrix_mutau(self):
        return np.diag([0.0, self.v_lri, -self.v_lri])


# ---------------------------------------------------------------------------
# Earth tomography (cf. reference scaling_params.py)
# ---------------------------------------------------------------------------
FIVE_LAYER_RADII_KM = np.array([0.0, 1221.50, 3480.00, 5701.00, 6151.0, 6371.00])
FIVE_LAYER_RHOS = np.array([13.0, 13.0, 10.96, 5.03, 3.7, 2.5])  # g/cm^3

TOMOGRAPHY_ERROR_MSG = (
    "You need to provide the appropriate 5-layer Earth model, with the same"
    f" layer radii ({FIVE_LAYER_RADII_KM} km) and densities"
    f" ({FIVE_LAYER_RHOS} g/cm^3) as the one hard-coded for the chosen type"
    " of tomography."
)


class Mass_scaling:
    """Single overall density scale factor."""

    def __init__(self):
        self._density_scale = 0.0

    @property
    def density_scale(self):
        return self._density_scale

    @density_scale.setter
    def density_scale(self, value):
        assert value >= 0.0
        self._density_scale = value


def _mass_and_inertia_coeffs():
    """Per-shell mass (4pi/3 rho (r_o^3 - r_i^3)) and moment-like
    (8pi/15 rho (r_o^5 - r_i^5)) coefficients of the 5-layer model."""
    r = FIVE_LAYER_RADII_KM
    rho = FIVE_LAYER_RHOS
    m = []
    i_ = []
    for k in range(1, 6):
        m.append(4 * np.pi / 3 * rho[k] * (r[k] ** 3 - r[k - 1] ** 3))
        i_.append(8 * np.pi / 15 * rho[k] * (r[k] ** 5 - r[k - 1] ** 5))
    return np.asarray(m), np.asarray(i_)


class Core_scaling_w_constrain:
    """Scale the core density by ``core_density_scale`` while conserving the
    Earth's total mass and moment of inertia by solving for the inner/middle
    mantle factors (outer mantle unscaled). Returned array is surface-first
    (index 0 = outermost shell), as consumed by ``Layers.scaling``."""

    def __init__(self):
        self._core_density_scale = 0.0

    @property
    def core_density_scale(self):
        return self._core_density_scale

    @core_density_scale.setter
    def core_density_scale(self, value):
        self._core_density_scale = value

    @property
    def scaling_array(self):
        (a1, b1, c1, d1, e1), (a2, b2, c2, d2, e2) = _mass_and_inertia_coeffs()
        M = a1 + b1 + c1 + d1 + e1
        I = a2 + b2 + c2 + d2 + e2  # noqa: E741 - physics notation
        alpha = self.core_density_scale
        gamma = (
            (I * c1 - M * c2)
            - alpha * (c1 * a2 - c2 * a1)
            - alpha * (c1 * b2 - b1 * c2)
            - (c1 * e2 - e1 * c2)
        ) / (c1 * d2 - d1 * c2)
        beta = (I - alpha * a2 - alpha * b2 - gamma * d2 - e2) / c2
        factors = np.asarray([alpha, beta, gamma])
        assert np.all(factors >= 0), "density scaling factors must be >= 0"
        # surface-first: [outer mantle(=1), middle mantle, inner mantle, cores]
        return np.array([1.0, gamma, beta, alpha, alpha, alpha])


class Core_scaling_wo_constrain:
    """Independent core / inner-mantle / middle-mantle scale factors."""

    def __init__(self):
        self.core_density_scale = 0.0
        self.innermantle_density_scale = 0.0
        self.middlemantle_density_scale = 0.0

    @property
    def scaling_factor_array(self):
        a = self.core_density_scale
        return np.array(
            [
                1.0,
                self.middlemantle_density_scale,
                self.innermantle_density_scale,
                a,
                a,
                a,
            ]
        )
