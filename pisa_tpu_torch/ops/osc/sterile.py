"""
3+1 (three active + one sterile) neutrino oscillations through layered
matter.

Counterpart of ``pisa_tpu/ops/osc/sterile.py`` (the native replacement for
the external nuSQuIDS engine of the reference's ``nusquids`` service), in
complex torch tensors with the batch axes leading: a batch of 4x4 matrices
is ``(..., 4, 4)``. The physics inputs (``dm_vac4`` (..., 4), the mixing
matrix (..., 4, 4)) may carry a leading lane axis, B independent parameter
points over the same geometry; every output then has it too. Nothing writes
in place into a tensor that depends on them, so ``torch.func.jacfwd`` and
``torch.func.vmap`` run through every function here.

The physics, as the JAX package computes it:

- the mixing matrix in the nuSQuIDS rotation order
  ``U = R34 R24(dcp24) R14(dcp14) R23 R13(dcp13) R12`` (:func:`pmns4_matrix`);
- per layer step, the flavour-basis Hamiltonian ``U diag(0, dm21, dm31,
  dm41) U^dagger / 2E + diag(a_e, 0, 0, a_n / 2)`` with the CC potential on
  nu_e and the neutron-weighted NC one on nu_s (signs flipped and U
  conjugated for antineutrinos); its eigenvalues, sorted, from
  :func:`~pisa_tpu_torch.ops.osc.herm4.eigvalsh4` (the hand-written CUDA
  kernel on a card, whose ``torch.linalg.eigvalsh`` counterpart would wait
  for the host); its **deflated** spectral projectors in the mass basis
  (the isolated, sterile-like state first, then the active cluster's most
  isolated extreme, then the remaining pair from the twice-deflated
  matrix: what keeps float32 unitary at the TeV resonance), and the phases;
- the amplitude picture: ``T = sum_k e^{-i m_k L / 2E} P_k``, one
  Newton-Schulz step towards unitarity (:func:`_unitarize`), the ordered
  chain product and the rotation to the flavour basis;
- the low-pass density-matrix picture (nuSQuIDS
  ``Set_EvolLowPassCutoff/Scale``): ``rho' = sum_kj c_k conj(c_j) f_kj P_k
  rho P_j^dagger`` with ``f_kj`` a cosine ramp on the pair's spatial
  frequency, computed as ``sum_k P_k (sum_j w_kj rho P_j^dagger)``: 8
  products a layer step where the JAX scan does 16, which halves what the
  backward keeps.

The JAX package builds every (layer, point) slot and masks the zero-length
ones; here the geometry is prepared once (:func:`prepare_4nu_geometry`):
each chain's real slots (distance > 0; a zero-length slot is the identity)
moved to its front in chain order, the points sorted by chain length, and
the steps laid out layer after layer, so that layer l's steps belong to a
suffix of the sorted points. The layer algebra runs over the real steps
only, in one batch; the chain loop then updates, layer by layer, only the
points whose chain reaches that far (slices, no index ops). Nothing in
:func:`propagate_4nu` reads a tensor on the host, so a CUDA graph captures
it forward and backward.

The split-complex ``C`` pairs, the 8x8 real embedding of the eigenvalue
problem and the einsum-only products of the JAX package are TPU
workarounds and are not carried over. The two ``jax.lax.scan`` chains are
loops over the real layer slots.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pisa_tpu_torch.ops.osc.chain import theta_tensor
from pisa_tpu_torch.ops.osc.herm4 import eigvalsh4
from pisa_tpu_torch.ops.osc.kernels import (
    HBAR_C_FACTOR,
    TWO_SQRT2_GF,
    _abs2,
    _complex_dtype,
    _conj,
    _dagger,
    _mm,
)

__all__ = [
    "pmns4_matrix",
    "layer_hamiltonians",
    "prepare_4nu_geometry",
    "propagate_4nu",
    "osc_probs_layers_4nu",
]


# ---------------------------------------------------------------------------
# the 4-flavour mixing matrix
# ---------------------------------------------------------------------------
def _rot(i, j, c, s, cd=None, sd=None):
    """Complex Givens rotation R_ij(theta, delta) (..., 4, 4): c at [i, i]
    and [j, j]; s e^{-i delta} at [i, j]; -s e^{+i delta} at [j, i]."""
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    re = [[one if a == b else zero for b in range(4)] for a in range(4)]
    im = [[zero] * 4 for _ in range(4)]
    re[i][i] = re[j][j] = c
    if cd is None:
        re[i][j], re[j][i] = s, -s
    else:
        re[i][j], re[j][i] = s * cd, -s * cd
        im[i][j] = im[j][i] = -s * sd

    def matrix(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    return torch.complex(matrix(re), matrix(im))


def pmns4_matrix(theta12, theta13, theta23, theta14, theta24, theta34,
                 deltacp13=0.0, deltacp14=0.0, deltacp24=0.0, device=None,
                 lanes=None):
    """3+1 mixing matrix in the nuSQuIDS rotation order, complex128 (4, 4)
    (angles in rad: numbers, 0-d tensors, or with `lanes` one value per lane,
    which gives (lanes, 4, 4); numbers are filled in on `device`, as
    :func:`~pisa_tpu_torch.ops.osc.chain.theta_tensor` does).

    ``U = R34 R24(dcp24) R14(dcp14) R23 R13(dcp13) R12``: for ``theta14 =
    theta24 = theta34 = 0`` the active 3x3 block is the standard PDG PMNS
    matrix."""
    th = theta_tensor([theta12, theta13, theta23, theta14, theta24, theta34,
                       deltacp13, deltacp14, deltacp24], device=device,
                      lanes=lanes)
    c, s = torch.cos(th), torch.sin(th)

    def rot(i, j, k, d=None):
        if d is None:
            return _rot(i, j, c[..., k], s[..., k])
        return _rot(i, j, c[..., k], s[..., k], c[..., d], s[..., d])

    r12, r13, r23 = rot(0, 1, 0), rot(0, 2, 1, 6), rot(1, 2, 2)
    r14, r24, r34 = rot(0, 3, 3, 7), rot(1, 3, 4, 8), rot(2, 3, 5)
    return _mm(_mm(_mm(r34, r24), r14), _mm(r23, _mm(r13, r12)))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
def prepare_4nu_geometry(energy, densities, densities_neutron, distances, *,
                         dtype, device):
    """The propagation's static inputs, from the (numpy) geometry of N
    points: each chain's real slots (distance > 0) moved to its front in
    chain order, the points sorted by the number of them, and the real
    steps laid out layer after layer.

    Parameters
    ----------
    energy : (N,) GeV
    densities, densities_neutron : (N, L) electron- and neutron-weighted
        column densities (mol/cm^3)
    distances : (N, L) layer lengths (km); zero-length slots are identity

    Returns a dict: ``e``, ``rho_e``, ``rho_n``, ``dist`` (M,) tensors in
    `dtype` on `device`, one entry per real step; ``inv`` (N,) int64, which
    puts the sorted points back in order; and on the host ``n`` (N),
    ``starts`` (layer l's steps belong to the sorted points ``starts[l]:``)
    and ``offsets`` (layer l's steps are ``offsets[l]:offsets[l + 1]``).
    """
    energy = np.asarray(energy, dtype=np.float64).reshape(-1)
    densities = np.asarray(densities, dtype=np.float64)
    densities_neutron = np.asarray(densities_neutron, dtype=np.float64)
    distances = np.asarray(distances, dtype=np.float64)
    real = distances > 0.0
    counts = np.count_nonzero(real, axis=1)
    order = np.argsort(counts, kind="stable")
    front = np.argsort(~real, axis=1, kind="stable")[order]
    rho_e, rho_n, dist = (np.take_along_axis(x[order], front, axis=1)
                          for x in (densities, densities_neutron, distances))
    counts, e_sorted = counts[order], energy[order]
    n = energy.shape[0]
    starts, offsets, steps = [], [0], ([], [], [], [])
    for layer in range(int(counts.max()) if n else 0):
        start = int(np.searchsorted(counts, layer, side="right"))
        starts.append(start)
        offsets.append(offsets[-1] + n - start)
        for out, x in zip(steps, (e_sorted, rho_e[:, layer], rho_n[:, layer],
                                  dist[:, layer])):
            out.append(x[start:])

    def put(parts):
        flat = np.concatenate(parts) if parts else np.zeros(0)
        return torch.as_tensor(flat, dtype=dtype, device=device)

    geom = dict(zip(("e", "rho_e", "rho_n", "dist"), map(put, steps)))
    geom.update(n=n, starts=tuple(starts), offsets=tuple(offsets),
                inv=torch.as_tensor(np.argsort(order), device=device))
    return geom


# ---------------------------------------------------------------------------
# the layer step
# ---------------------------------------------------------------------------
def layer_hamiltonians(U, dm_vac4, nubar, energy, rho_e, rho_n):
    """The flavour-basis Hamiltonians of M layer steps (``energy``,
    ``rho_e``, ``rho_n`` (M,)), complex (..., M, 4, 4): ``U diag(0, dm21,
    dm31, dm41) U^dagger / 2E`` plus the matter potentials ``diag(a_e, 0, 0,
    a_n / 2)`` (signs flipped for nubar), with `U` (..., 4, 4) the
    already-conjugated (for nubar) mixing matrix: the matrices whose
    eigenvalues the kernel takes."""
    d = torch.stack([torch.zeros_like(dm_vac4[..., 1]), dm_vac4[..., 1],
                     dm_vac4[..., 2], dm_vac4[..., 3]], dim=-1).to(U.dtype)
    H_vac = _mm(U * d[..., None, :], _dagger(U))  # (..., 4, 4), no 1/2E
    sign = 1.0 if nubar > 0 else -1.0
    a_e = (0.5 * TWO_SQRT2_GF * sign) * rho_e
    a_s = (0.25 * TWO_SQRT2_GF * sign) * rho_n  # nu_s: -V_NC = +a_n / 2
    zero = torch.zeros_like(a_e)
    diag = torch.diag_embed(torch.stack([a_e, zero, zero, a_s], dim=-1))
    return H_vac[..., None, :, :] * (0.5 / energy)[:, None, None] + diag


def _layer_phase_and_projectors(U, dm_vac4, nubar, energy, rho_e, rho_n,
                                baseline):
    """The per-step algebra over a flat batch of M steps (``energy``,
    ``rho_e``, ``rho_n``, ``baseline`` (M,)): the mass-basis projectors P_k
    (a list of 4 complex (..., M, 4, 4)), their eigenvalues m (..., M, 4)
    (2E-scaled, aligned with the projectors) and the phases c_k =
    exp(-i m_k L hbar_c / E) (a list of 4 complex (..., M)). `U` (..., 4, 4)
    is the already-conjugated (for nubar) mixing matrix
    (``_layer_phase_and_projectors`` of the JAX package)."""
    H_full = layer_hamiltonians(U, dm_vac4, nubar, energy, rho_e, rho_n)
    two_e = 2.0 * energy
    m = eigvalsh4(H_full) * two_e[:, None]  # (..., M, 4), ascending

    Ub = U[..., None, :, :]
    H2e = _mm(_mm(_dagger(Ub), H_full), Ub) * two_e[:, None, None]
    eye = torch.eye(4, dtype=U.dtype, device=U.device)

    def fac(X, c, denom):  # (X - c I) / denom
        return (X - eye * c[..., None, None]) / denom[..., None, None]

    def sel(cond, x, y):
        return torch.where(cond[..., None, None], x, y)

    # The isolated (sterile-like) state's projector first: all of its gaps
    # are ~dm41, so it is well conditioned; the cluster's from the deflated
    # A = Q H2e Q, whose spectral radius is the cluster's.
    m0, m1, m2, m3 = m.unbind(-1)
    far_is_3 = (m3 - m2) >= (m1 - m0)
    m_far = torch.where(far_is_3, m3, m0)
    mc = [torch.where(far_is_3, m0, m1), torch.where(far_is_3, m1, m2),
          torch.where(far_is_3, m2, m3)]
    P_far = _mm(fac(H2e, mc[0], m_far - mc[0]),
                _mm(fac(H2e, mc[1], m_far - mc[1]),
                    fac(H2e, mc[2], m_far - mc[2])))
    Q = eye - P_far
    A = _mm(Q, _mm(H2e, Q))

    # At high energy mu and tau feel the same potentials and two cluster
    # eigenvalues nearly coincide: split off the cluster's most isolated
    # extreme, deflate again, and build the pair's projectors from A2, whose
    # spectral radius is the pair's spread.
    iso_is_2 = (mc[2] - mc[1]) >= (mc[1] - mc[0])
    m_iso = torch.where(iso_is_2, mc[2], mc[0])
    m_p = torch.where(iso_is_2, mc[0], mc[1])
    m_q = torch.where(iso_is_2, mc[1], mc[2])
    P_iso = _mm(fac(A, m_p, m_iso - m_p), fac(A, m_q, m_iso - m_q))
    P_iso = _mm(Q, _mm(P_iso, Q))
    Q2 = Q - P_iso
    A2 = _mm(Q2, _mm(A, Q2))
    P_p = _mm(Q2, _mm(fac(A2, m_q, m_p - m_q), Q2))
    P_q = Q2 - P_p

    projectors = [sel(iso_is_2, P_p, P_iso), sel(iso_is_2, P_q, P_p),
                  sel(iso_is_2, P_iso, P_q), P_far]
    m_list = mc + [m_far]
    s = -(baseline / energy) * HBAR_C_FACTOR
    phases = [torch.complex(torch.cos(mk * s), torch.sin(mk * s))
              for mk in m_list]
    return projectors, torch.stack(m_list, dim=-1), phases


def _unitarize(T):
    """One Newton-Schulz polar step ``T <- 1.5 T - 0.5 T (T^dagger T)``: the
    float32 projector error leaves ``T = W (I + S)`` with W unitary and S
    small Hermitian, and one step maps it to ``W (I + O(S^2))``, removing
    the part of the error that would accumulate as unitarity violation along
    the chain (a no-op at float64 precision)."""
    return 1.5 * T - 0.5 * _mm(T, _mm(_dagger(T), T))


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------
def propagate_4nu(dm_vac4, mix4, nubar, geom, lowpass_cutoff=0.0,
                  lowpass_frac=0.1):
    """3+1 probabilities over :func:`prepare_4nu_geometry` output: (N, 4, 4),
    ``probs[n, a, b] = P(nu_a -> nu_b)``, flavour order (e, mu, tau, s), in
    the original point order; (B, N, 4, 4) for lanes.

    `dm_vac4` (..., 4) real, (0, dm21, dm31, dm41) in eV^2, and `mix4`
    (..., 4, 4) complex (:func:`pmns4_matrix`, conjugated here for nubar),
    on the geometry's device; they are cast to its type. `lowpass_cutoff`
    (1/km; 0 disables) switches to the density-matrix picture, damping the
    interference of eigenstate pairs whose spatial frequency passes
    ``(1 - lowpass_frac) * lowpass_cutoff`` with a cosine ramp."""
    e = geom["e"]
    real = e.dtype
    cplx = _complex_dtype(real)
    mix4 = mix4.to(cplx)
    U = mix4 if nubar > 0 else _conj(mix4)
    n = geom["n"]
    starts, offsets = geom["starts"], geom["offsets"]
    projectors, m, phases = _layer_phase_and_projectors(
        U, dm_vac4.to(real), nubar, e, geom["rho_e"], geom["rho_n"],
        geom["dist"])
    lead = tuple(projectors[0].shape[:-3])
    eye = torch.eye(4, dtype=cplx, device=e.device)

    if not lowpass_cutoff:
        T = sum(c[..., None, None] * P for c, P in zip(phases, projectors))
        T = _unitarize(T)
        product = eye.expand(lead + (n, 4, 4))
        for layer, start in enumerate(starts):
            T_l = T[..., offsets[layer]:offsets[layer + 1], :, :]
            product = torch.cat([product[..., :start, :, :],
                                 _mm(T_l, product[..., start:, :, :])], dim=-3)
        Uf = U[..., None, :, :]
        product = _mm(_mm(Uf, product), _dagger(Uf))
        # probs[n, a, b] = |T_flavour[n, b, a]|^2
        probs = _abs2(product).transpose(-1, -2)
        return probs.index_select(-3, geom["inv"])

    # low-pass density-matrix picture: pair damping from the spatial
    # frequency of (m_k - m_j)
    freq = (m[..., :, None] - m[..., None, :]).abs() * (
        HBAR_C_FACTOR / e)[:, None, None]  # (..., M, 4, 4) rad/km
    lo = (1.0 - lowpass_frac) * lowpass_cutoff
    ramp = torch.clamp((freq - lo) / max(lowpass_cutoff - lo, 1e-12), 0.0, 1.0)
    f = 0.5 * (1.0 + torch.cos(math.pi * ramp))  # 1 below, 0 above
    c = torch.stack(phases, dim=-1)  # (..., M, 4)
    w = c[..., :, None] * _conj(c)[..., None, :] * f  # w_kj
    # one density matrix per initial flavour a, in the mass basis:
    # rho_a = v v^dagger with v = conj(U[a, :]); (..., N, a, 4, 4)
    rho0 = _conj(U)[..., :, :, None] * U[..., :, None, :]
    rho = rho0[..., None, :, :, :].expand(lead + (n, 4, 4, 4))
    for layer, start in enumerate(starts):
        lo_s, hi_s = offsets[layer], offsets[layer + 1]
        P = [p[..., lo_s:hi_s, None, :, :] for p in projectors]
        w_l = w[..., lo_s:hi_s, :, :]
        sub = rho[..., start:, :, :, :]
        Y = [_mm(sub, _dagger(p)) for p in P]  # rho P_j^dagger
        out = sum(
            _mm(P[k], sum(w_l[..., k, j, None, None, None] * Y[j]
                          for j in range(4)))
            for k in range(4))
        rho = torch.cat([rho[..., :start, :, :, :], out], dim=-4)
    # back to the flavour basis: P(a -> b) = (U rho_a U^dagger)[b, b]
    Uf = U[..., None, None, :, :]
    rho_f = _mm(_mm(Uf, rho), _dagger(Uf))
    probs = torch.diagonal(rho_f, dim1=-2, dim2=-1).real  # (..., N, a, b)
    return probs.index_select(-3, geom["inv"])


def osc_probs_layers_4nu(dm_vac4, mix4, nubar, energy, densities,
                         densities_neutron, distances, lowpass_cutoff=0.0,
                         lowpass_frac=0.1):
    """3+1 oscillation probabilities through chains of matter layers
    (``osc_probs_layers_4nu`` of the JAX package): the geometry prepared
    from `energy` (N,), `densities`, `densities_neutron` and `distances`
    (N, L) (tensors or arrays, read on the host), then
    :func:`propagate_4nu` in the energy's type on its device (CPU for
    arrays). Returns (N, 4, 4), ``probs[n, a, b] = P(nu_a -> nu_b)``, or
    (B, N, 4, 4) for lanes of `dm_vac4` (B, 4) and `mix4` (B, 4, 4)."""
    if isinstance(energy, torch.Tensor):
        dtype, device = energy.dtype, energy.device
    else:
        dtype, device = torch.as_tensor(np.asarray(energy)).dtype, "cpu"

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    geom = prepare_4nu_geometry(host(energy), host(densities),
                                host(densities_neutron), host(distances),
                                dtype=dtype, device=device)
    return propagate_4nu(torch.as_tensor(dm_vac4, device=device), mix4,
                         int(nubar), geom, lowpass_cutoff=lowpass_cutoff,
                         lowpass_frac=lowpass_frac)
