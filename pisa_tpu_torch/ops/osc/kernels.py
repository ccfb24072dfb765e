"""
Three-flavour matter oscillations in the general formulation: any complex
matter potential (NSI), a non-Hermitian decay term, a long-range-interaction
potential, deduplicated layer chains.

Counterpart of ``pisa_tpu/ops/osc/kernels.py`` (the JAX package's XLA
formulation; reference ``pisa/stages/osc/prob3numba/numba_osc_kernels.py``),
in complex torch tensors with the batch axes leading: a batch of 3x3
matrices is ``(..., 3, 3)``. The physics inputs (``dm_vac``, the mixing
matrix, the matter, decay and LRI potentials) may carry a leading lane axis,
``(B, 3, 3)``, B independent parameter points over the same geometry (the
batched fits' lanes, what ``jax.vmap`` adds to the JAX package's); every
output then has it too. Nothing writes in place into a tensor that depends
on the physics inputs, so ``torch.func.jacfwd`` (forward mode) and
``torch.func.vmap`` run through every function here. This is not the plain
version of a CUDA kernel (those are ``chain.py:chain_*_reference``): it is
the route that
``stages/osc/prob3.py`` takes for neutrino decay and layer dedup, which no
kernel computes, and the backward of the general-pack route
(``chain.py:OscProbsGeneral``).

The propagation (:func:`propagate_layers`) builds every real layer step's
transition amplitude at once, over the flat (layer, point) batch compacted
to the real slots by a host-precomputed ``slot_index`` (or over the unique
slots of a deduplicated chain, expanded by ``chain_map``), then takes the
ordered chain product. Nothing in it reads a tensor on the host, so a
CUDA-graph capture takes it forward and backward. The real slots' amplitudes
are put into the full stack by a gather (an index of every slot into them or
into a trailing identity, built on the device from ``slot_index``), not by
a scatter, which forward mode and vmap take as any other op.

Eigenvalues: the Hermitian case by the closed trigonometric form, ordered by
vacuum matching (``_dms``); the decay case by Cardano's closed form
(``_eigvals``; the Barger amplitude is permutation-symmetric, so their order
does not matter), not ``torch.linalg.eigvals``, whose CUDA path waits for
the host. Cardano's square and cube roots are torch's complex ``sqrt`` and
``pow``, whose derivatives are finite wherever the root is not 0: the JAX
package's half-angle square root has an infinite derivative at a negative
real discriminant (every Hermitian matrix has one), which makes its float32
decay gradient NaN. That fault is not copied.

Physical conventions (reference Appendix B):
- nubar = +1 nu / -1 nubar; flavours 0=e, 1=mu, 2=tau
- matter potential a = 0.5 * rho * 1.52588e-4 [eV^2 cm^3 / (mol GeV)];
  nubar: H_mat -> -a * conj(mat_pot)
- LRI potential added as +/- lri_pot * 1e9 (eV -> GeV units bridge)
- hbar*c factor 2.534 GeV/(eV^2 km) in transition phases
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "get_H_vac",
    "get_H_decay",
    "get_H_mat",
    "get_dms",
    "get_dms_numerical",
    "eigvals3x3",
    "get_transition_matrix",
    "osc_probs_layers",
    "propagate_layers",
    "check_slot_index",
    "propagate_grid",
]

TWO_SQRT2_GF = 1.52588e-4  # 2*sqrt(2)*G_F in (eV^2 cm^3)/(mole GeV)
HBAR_C_FACTOR = 2.534  # (1/2)/(hbar c) in GeV/(eV^2 km)


def _conj(z):
    """The conjugate built explicitly: a lazily conjugated view has no vmap
    rule for ``.imag``, nor its backward (``aten::_neg_view``), which
    ``torch.func`` transforms of the formulation and the pack need."""
    return torch.complex(z.real, -z.imag)


def _dagger(a):
    return _conj(a).transpose(-1, -2)


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


def _mm(a, b):
    """a @ b over the trailing (3, 3) axes of batched complex matrices, as
    one broadcast product and one sum: elementwise kernels over the batch.
    (``torch.matmul`` of (M, 3, 3) batches runs cuBLAS's batched complex
    GEMM with 32x32 tiles, ~0.17 ms a product over the flagship's 279,600
    layer steps on an H100: most of an NSI ``value_and_grad``, PERF.md.)"""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _complex_dtype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


# ---------------------------------------------------------------------------
# Hamiltonians
# ---------------------------------------------------------------------------
def get_H_vac(mix_nubar, dm_vac):
    """Vacuum Hamiltonian in the flavour basis, without the 1/2E factor:
    U diag(0, dm21, dm31) U^dagger (``numba_osc_kernels.py:535``); (3, 3),
    or (B, 3, 3) for lanes."""
    d = torch.stack([torch.zeros_like(dm_vac[..., 1, 0]), dm_vac[..., 1, 0],
                     dm_vac[..., 2, 0]], dim=-1).to(mix_nubar.dtype)
    return (mix_nubar * d[..., None, :]) @ _dagger(mix_nubar)


def get_H_decay(mix_nubar, mat_decay):
    """Decay Hamiltonian in the flavour basis, without the 1/2E factor
    (``numba_osc_kernels.py:572``)."""
    return mix_nubar @ mat_decay.to(mix_nubar.dtype) @ _dagger(mix_nubar)


def get_H_mat(rho, mat_pot, nubar):
    """Matter Hamiltonian in the flavour basis: a*mat_pot (nu) or
    -a*conj(mat_pot) (nubar), a = 0.5*rho*2sqrt2*G_F
    (``numba_osc_kernels.py:606``). `rho` is a number or an (N,) tensor,
    which gives (N, 3, 3) (lanes of `mat_pot`, (B, 3, 3), give (B, N, 3,
    3))."""
    a = 0.5 * torch.as_tensor(rho, dtype=mat_pot.real.dtype,
                              device=mat_pot.device) * TWO_SQRT2_GF
    a = a[..., None, None]
    if a.dim() > 2:
        mat_pot = mat_pot[..., None, :, :]
    if nubar > 0:
        return mat_pot * a
    return _conj(mat_pot) * (-a)


# ---------------------------------------------------------------------------
# Eigenvalues
# ---------------------------------------------------------------------------
def _normalized(H):
    """H / s with s the largest |H_ij| (floored at 1e-30), and s: the
    characteristic polynomial's raw coefficients underflow float32 at TeV
    energies; eigenvalues are degree-1 homogeneous in H."""
    scale2 = _abs2(H).flatten(-2).amax(-1)
    scale = torch.clamp(torch.sqrt(scale2), min=1e-30)
    return H * (1.0 / scale)[..., None, None], scale


def _dms(energy, H, dm_vac):
    """Matter mass-squared eigenvalues (2E*lambda) of the Hermitian
    flavour-basis Hamiltonian H (..., 3, 3) by the analytic trigonometric
    solution, vacuum-match ordered (``numba_osc_kernels.py:688``;
    ``_dms_soa_scalars`` :207 of the JAX package). `dm_vac` (..., 3, 3)
    broadcasts against H's batch shape. Returns [m0, m1, m2], real tensors
    of the batch shape."""
    dm00, dm10, dm20 = dm_vac[..., 0, 0], dm_vac[..., 1, 0], dm_vac[..., 2, 0]
    Hs, scale = _normalized(H)

    def el(i, j):
        return Hs[..., i, j]

    real_product_a = (el(0, 1) * el(1, 2) * el(2, 0)).real
    real_product_b = (el(0, 0) * el(1, 1) * el(2, 2)).real
    norm_emu = _abs2(el(0, 1))
    norm_etau = _abs2(el(0, 2))
    norm_mutau = _abs2(el(1, 2))

    c1 = (
        el(0, 0).real * (el(1, 1).real + el(2, 2).real)
        - el(0, 0).imag * (el(1, 1).imag + el(2, 2).imag)
        + el(1, 1).real * el(2, 2).real
        - el(1, 1).imag * el(2, 2).imag
        - norm_emu
        - norm_mutau
        - norm_etau
    )
    c0 = (
        el(0, 0).real * norm_mutau
        + el(1, 1).real * norm_etau
        + el(2, 2).real * norm_emu
        - 2.0 * real_product_a
        - real_product_b
    )
    c2 = -el(0, 0).real - el(1, 1).real - el(2, 2).real

    one_over_two_e = 0.5 / energy
    # vacuum analog, scale-normalized the same way
    scale_v = torch.clamp(
        torch.maximum(dm10.abs(), dm20.abs()) * one_over_two_e, min=1e-30)
    x = dm10 * one_over_two_e / scale_v
    y = dm20 * one_over_two_e / scale_v
    c2_v = -(x + y)

    p = torch.clamp(c2 * c2 - 3.0 * c1, min=0.0)
    p_v = x * x + y * y - x * y
    q = -13.5 * c0 - c2 ** 3 + 4.5 * c1 * c2
    q_v = (x + y) * ((x + y) ** 2 - 4.5 * x * y)

    # p^3 - q^2 rewritten for numerical stability (cf. reference :777)
    tmp = torch.clamp(
        27.0 * (0.25 * c1 * c1 * (p - c1) + c0 * (q + 6.75 * c0)), min=0.0)
    tmp_v = torch.clamp(p_v ** 3 - q_v ** 2, min=0.0)

    res = torch.atan2(torch.sqrt(tmp), q) / 3.0
    res_v = torch.atan2(torch.sqrt(tmp_v), q_v) / 3.0
    a = 2.0 / 3.0 * math.pi
    b = 2.0 / 3.0 * torch.sqrt(p)
    b_v = 2.0 / 3.0 * torch.sqrt(p_v)

    two_e = 2.0 * energy
    m_u = [
        two_e * (scale * (b * torch.cos(res + a) - c2 / 3.0) + dm00),
        two_e * (scale * (b * torch.cos(res - a) - c2 / 3.0) + dm00),
        two_e * (scale * (b * torch.cos(res) - c2 / 3.0) + dm00),
    ]
    m_v = [
        two_e * (scale_v * (b_v * torch.cos(res_v + a) - c2_v / 3.0) + dm00),
        two_e * (scale_v * (b_v * torch.cos(res_v - a) - c2_v / 3.0) + dm00),
        two_e * (scale_v * (b_v * torch.cos(res_v) - c2_v / 3.0) + dm00),
    ]

    # vacuum-matched ordering: m[i] = m_u[argmin_j |dm_vac[i,0] - m_v[j]|],
    # branch-free over the 3x3 candidate pairs
    out = []
    for target in (dm00, dm10, dm20):
        d0, d1, d2 = ((target - mv).abs() for mv in m_v)
        best01 = torch.where(d1 < d0, m_u[1], m_u[0])
        out.append(torch.where(d2 < torch.minimum(d0, d1), m_u[2], best01))
    return out


def get_dms(energy, H_full, dm_vac):
    """Real matter mass-squared eigenvalues of the Hermitian H_full (3, 3)
    (or (..., 3, 3), with `dm_vac` (3, 3) or of H's batch shape): (3,) (or
    (3, ...))."""
    energy = torch.as_tensor(energy, dtype=H_full.real.dtype,
                             device=H_full.device)
    return torch.stack(_dms(energy, H_full, dm_vac))


def _eigvals(H):
    """Cardano closed-form eigenvalues of general complex (..., 3, 3)
    matrices (scale-normalized; arbitrary order): a list of 3 complex
    tensors of the batch shape (``_eigvals_soa`` :316 of the JAX
    package)."""
    e, scale = _normalized(H)

    def el(i, j):
        return e[..., i, j]

    c2 = -(el(0, 0) + el(1, 1) + el(2, 2))
    c1 = (el(0, 0) * el(1, 1) + el(0, 0) * el(2, 2) + el(1, 1) * el(2, 2)
          - el(0, 1) * el(1, 0) - el(0, 2) * el(2, 0) - el(1, 2) * el(2, 1))
    c0 = -(
        el(0, 0) * (el(1, 1) * el(2, 2) - el(1, 2) * el(2, 1))
        - el(0, 1) * (el(1, 0) * el(2, 2) - el(1, 2) * el(2, 0))
        + el(0, 2) * (el(1, 0) * el(2, 1) - el(1, 1) * el(2, 0))
    )
    third = 1.0 / 3.0
    p = c1 - c2 * c2 * third
    q = c2 * c2 * c2 * (2.0 / 27.0) - c2 * c1 * third + c0
    half_q = 0.5 * q
    disc = half_q * half_q + (p * third) * (p * third) * (p * third)
    sq = torch.sqrt(disc)
    u3a = -half_q + sq
    u3b = -half_q - sq
    u3 = torch.where(_abs2(u3a) >= _abs2(u3b), u3a, u3b)
    u = torch.pow(u3, third)
    u_zero = _abs2(u) == 0
    u_safe = torch.where(u_zero, torch.ones_like(u), u)
    v = torch.where(u_zero, torch.zeros_like(u), (p * third) / u_safe)
    ang = 2.0 * math.pi / 3.0
    w = complex(math.cos(ang), math.sin(ang))
    w2 = w * w
    shift = c2 * third
    roots = [u - v - shift, u * w - v / w - shift, u * w2 - v / w2 - shift]
    return [r * scale for r in roots]


def eigvals3x3(H):
    """Eigenvalues of a complex (3, 3) (or (..., 3, 3)) matrix: (3,) (or
    (3, ...)) complex."""
    return torch.stack(_eigvals(H))


def get_dms_numerical(energy, H_full):
    """Complex matter mass-squared eigenvalues 2E*eig(H_full) for the decay
    case (``numba_osc_kernels.py:656``)."""
    return eigvals3x3(H_full) * (2.0 * energy)


# ---------------------------------------------------------------------------
# Barger transition amplitude
# ---------------------------------------------------------------------------
def _phase(m, s):
    """exp(i m s) for complex eigenvalues m and real s = -(L/E) hbar_c:
    e^{-Im(m) s} (cos(Re(m) s) + i sin(Re(m) s))."""
    ar = m.real * s
    ex = torch.exp(-m.imag * s)
    return torch.complex(ex * torch.cos(ar), ex * torch.sin(ar))


def _transition(baseline, energy, m, H_mass_2e):
    """Barger et al. eq. 10: the transition amplitude (mass basis) from the
    2E-scaled mass-basis Hamiltonian (..., 3, 3) and the eigenvalues `m`
    (3 complex tensors) (``numba_osc_kernels.py:482,835``)."""
    eye = torch.eye(3, dtype=H_mass_2e.dtype, device=H_mass_2e.device)
    h = [H_mass_2e - eye * mk[..., None, None] for mk in m]
    d01 = m[0] - m[1]
    d02 = m[0] - m[2]
    d12 = m[1] - m[2]
    inv = [1.0 / (d01 * d02), 1.0 / (d12 * (-d01)), 1.0 / ((-d02) * (-d12))]
    s = -(baseline / energy) * HBAR_C_FACTOR
    pairs = ((1, 2), (2, 0), (0, 1))
    T = None
    for k, (i, j) in enumerate(pairs):
        term = (_phase(m[k], s) * inv[k])[..., None, None] * _mm(h[i], h[j])
        T = term if T is None else T + term
    return T


def _layer_transition(nubar, energy, rho, baseline, U, mat_pot, H_vac,
                      H_decay, lri_pot, dm_vac, decay_flag):
    """One-layer transition amplitudes (mass basis) for a flat batch
    (``_layer_transition_stacked`` :471 of the JAX package).

    energy/rho/baseline: (M,); U/mat_pot/H_vac/H_decay: complex (3, 3);
    lri_pot/dm_vac: real (3, 3); or each of these (B, 3, 3) lanes. Returns
    complex (M, 3, 3), or (B, M, 3, 3)."""
    sign = 1.0 if nubar > 0 else -1.0

    def per_step(x):  # (..., 3, 3) -> (..., 1, 3, 3): broadcast over M
        return None if x is None else x[..., None, :, :]

    U, mat_pot, H_vac, H_decay, lri_pot, dm_vac = map(
        per_step, (U, mat_pot, H_vac, H_decay, lri_pot, dm_vac))
    a = (0.5 * TWO_SQRT2_GF) * rho
    mp = mat_pot if nubar > 0 else -_conj(mat_pot)
    # H_mat = a*mat_pot (nu) / -a*conj(mat_pot) (nubar), + LRI (real)
    H_mat = mp * a[:, None, None] + ((sign * 1e9) * lri_pot).to(mp.dtype)
    one_over_two_e = (0.5 / energy)[:, None, None]
    H_v = H_vac + H_decay if decay_flag else H_vac
    H_full = H_v * one_over_two_e + H_mat
    if decay_flag:
        m = [mk * (2.0 * energy) for mk in _eigvals(H_full)]
    else:
        m = [torch.complex(mk, torch.zeros_like(mk))
             for mk in _dms(energy, H_full, dm_vac)]
    H_mass_2e = _mm(_mm(_dagger(U), H_full), U) * (2.0 * energy)[:, None, None]
    return _transition(baseline, energy, m, H_mass_2e)


def get_transition_matrix(nubar, energy, rho, baseline, mix_nubar, mat_pot,
                          H_vac, H_decay, lri_pot, dm_vac, decay_flag=False):
    """Transition amplitude matrix (mass basis) for one layer
    (``numba_osc_kernels.py:349``): complex (3, 3) for scalar energy, rho
    and baseline, (N, 3, 3) for (N,) ones; lanes of the physics inputs,
    (B, 3, 3), give (B, 3, 3) or (B, N, 3, 3)."""
    real = mix_nubar.real.dtype
    device = mix_nubar.device

    def flat(x):
        return torch.as_tensor(x, dtype=real, device=device).reshape(-1)

    energy_t = torch.as_tensor(energy, dtype=real, device=device)
    T = _layer_transition(
        nubar, flat(energy), flat(rho), flat(baseline), mix_nubar, mat_pot,
        H_vac, H_decay, lri_pot, dm_vac, decay_flag)
    return T[..., 0, :, :] if energy_t.dim() == 0 else T


# ---------------------------------------------------------------------------
# Full propagation
# ---------------------------------------------------------------------------
def _osc_probs(dm_vac, U, mat_pot, mat_decay, lri_pot, nubar, energy,
               densities, distances, decay_flag=False, chain_map=None,
               slot_index=None):
    """The propagation over already-conjugated `U` (``_osc_probs_xla`` :766
    of the JAX package): (N, 3, 3) probabilities, or (B, N, 3, 3) for
    (B, 3, 3) lanes of the physics inputs.

    Every layer step's transition is built at once over the flat
    layer-major (layer, point) batch: compacted to the real slots by
    `slot_index` and put into an identity-filled stack, or, without it, over
    every slot with the zero-length ones replaced by the identity. With
    `chain_map`, `densities`/`distances` hold each chain's unique slots and
    the stack is expanded to the full chains by one gather. Then the ordered
    chain product, production first (each layer left-multiplies), and the
    rotation to the flavour basis."""
    H_vac = get_H_vac(U, dm_vac)
    H_decay = get_H_decay(U, mat_decay) if decay_flag else None
    n_pts = energy.shape[0]
    n_layers = distances.shape[1]
    e_flat = energy.expand(n_layers, n_pts).reshape(-1)
    rho_flat = densities.transpose(0, 1).reshape(-1)
    dist_flat = distances.transpose(0, 1).reshape(-1)
    eye = torch.eye(3, dtype=U.dtype, device=U.device)

    def transition(e, rho, dist):
        return _layer_transition(nubar, e, rho, dist, U, mat_pot, H_vac,
                                 H_decay, lri_pot, dm_vac, decay_flag)

    if slot_index is not None and chain_map is None:
        T_s = transition(e_flat.index_select(0, slot_index),
                         rho_flat.index_select(0, slot_index),
                         dist_flat.index_select(0, slot_index))
        # every slot's row of [T_s; identity]: its real step's, or the
        # identity's (the last)
        n_real = slot_index.shape[0]
        rows = torch.full((n_layers * n_pts,), n_real, dtype=torch.int64,
                          device=slot_index.device)
        rows = rows.index_copy(0, slot_index, torch.arange(
            n_real, dtype=torch.int64, device=slot_index.device))
        T = torch.cat([T_s, eye.expand(T_s.shape[:-3] + (1, 3, 3))],
                      dim=-3).index_select(-3, rows)
    else:
        T = transition(e_flat, rho_flat, dist_flat)
        T = torch.where((dist_flat > 0.0)[:, None, None], T, eye)
    if chain_map is not None:
        # the unique transitions expanded to the full (L, N) chains
        n_chain = chain_map.shape[1]
        points = torch.arange(n_pts, device=chain_map.device)
        sel = chain_map.transpose(0, 1).to(torch.int64) * n_pts + points
        T = T.index_select(-3, sel.reshape(-1))
        n_layers = n_chain
    T = T.reshape(T.shape[:-3] + (n_layers, n_pts, 3, 3))
    product = eye.expand(n_pts, 3, 3)
    for layer in range(n_layers):
        product = _mm(T[..., layer, :, :, :], product)
    U = U[..., None, :, :]
    product = _mm(_mm(U, product), _dagger(U))
    # probs[n, a, b] = |T_flavour[n, b, a]|^2
    return _abs2(product).transpose(-1, -2)


def check_slot_index(distances, slot_index):
    """Raises unless `slot_index` is the sorted flat layer-major index set of
    the real (distance > 0) slots of `distances` (``osc_probs_layers``
    :662-705 of the JAX package): a set that leaves out a real slot would
    turn that layer into the identity. Reads both on the host."""
    from pisa_tpu_torch.ops.osc.layers import layer_slot_index

    expected = layer_slot_index(distances.detach().cpu().numpy())
    given = slot_index.detach().cpu().numpy().ravel()
    if given.size == expected.size and np.array_equal(given, expected):
        return
    if given.size == expected.size:
        first = int(np.flatnonzero(given != expected)[0])
        detail = (f" sizes match ({given.size}) but contents differ, first at"
                  f" position {first}: got {given[first]}, expected"
                  f" {expected[first]}.")
    else:
        detail = f" expected {expected.size} indices, got {given.size}."
    raise ValueError(
        "slot_index inconsistent with distances (must be the SORTED flat"
        " layer-major indices of the distance>0 slots):" + detail
        + " Recompute slot_index (layers.layer_slot_index) whenever the layer"
        " chains change.")


def osc_probs_layers(dm_vac, mix, mat_pot, mat_decay, lri_pot, nubar, energy,
                     densities, distances, decay_flag=False, chain_map=None,
                     slot_index=None):
    """Oscillation probabilities through chains of matter layers, batched
    over points (``osc_probs_layers`` :631 of the JAX package; reference
    ``numba_osc_kernels.py:122``).

    Parameters
    ----------
    dm_vac : real (3, 3)
    mix : complex (3, 3) PMNS matrix (conjugated here for nubar)
    mat_pot : complex (3, 3) generalized matter potential (diag(1,0,0) std)
    mat_decay : complex (3, 3) decay matrix (-i*alpha3 at [2,2]), read only
        with `decay_flag`
    lri_pot : real (3, 3) LRI potential
        (each of these five may instead be (B, 3, 3), one per lane)
    nubar : +1 nu / -1 nubar
    energy : (N,) GeV
    densities, distances : (N, L) electron densities (mol/cm^3) and layer
        lengths (km); zero-length slots act as identity. With `chain_map`,
        each chain's unique (density, distance) pairs (N, Lu)
        (:func:`pisa_tpu_torch.ops.osc.layers.dedup_layers`)
    chain_map : optional (N, L) int tensor, chain slot -> unique slot
    slot_index : optional (M_real,) int64 tensor, the flat layer-major
        indices of the real slots (:func:`~pisa_tpu_torch.ops.osc.layers.
        layer_slot_index`); the transitions are then built over these only.
        Ignored with `chain_map`. Validated against `distances` on the host
        first (:func:`check_slot_index`).

    Returns (N, 3, 3) probabilities, ``probs[i, a, b] = P(nu_a -> nu_b)``,
    in the energy's real dtype (the physics inputs are cast to it); (B, N,
    3, 3) with lanes.
    """
    if slot_index is not None and chain_map is None:
        check_slot_index(distances, slot_index)
    return propagate_layers(
        dm_vac, mix, mat_pot, mat_decay, lri_pot, nubar, energy, densities,
        distances, decay_flag=decay_flag, chain_map=chain_map,
        slot_index=slot_index)


def propagate_layers(dm_vac, mix, mat_pot, mat_decay, lri_pot, nubar, energy,
                     densities, distances, decay_flag=False, chain_map=None,
                     slot_index=None):
    """:func:`osc_probs_layers` without the check of `slot_index`, which
    reads the card: for a caller that checked it when it built it, as
    ``stages/osc/prob3.py`` does at set-up, so that nothing waits for the
    card and a CUDA graph captures the call."""
    real = energy.dtype
    cplx = _complex_dtype(real)
    mix = mix.to(cplx)
    U = mix if nubar > 0 else torch.complex(mix.real, -mix.imag)
    return _osc_probs(
        dm_vac.to(real), U, mat_pot.to(cplx),
        None if mat_decay is None else mat_decay.to(cplx), lri_pot.to(real),
        nubar, energy, densities, distances, decay_flag=bool(decay_flag),
        chain_map=chain_map, slot_index=slot_index)


def propagate_grid(dm_vac, mix, mat_pot, mat_decay, lri_pot, nubar, energies,
                   densities, distances, decay_flag=False):
    """The reference host gufunc ``propagate_array``
    (``numba_osc_hostfuncs.py:65``): numpy in, numpy out, float64."""
    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    probs = osc_probs_layers(
        t(dm_vac), t(mix, torch.complex128), t(mat_pot, torch.complex128),
        t(mat_decay, torch.complex128), t(lri_pot), int(nubar),
        t(np.atleast_1d(energies)), t(np.atleast_2d(densities)),
        t(np.atleast_2d(distances)), decay_flag=bool(decay_flag))
    return probs.numpy()
