"""
Earth-layer chain propagation: the oscillation kernels and their gradient.

Counterpart of ``pisa_tpu/ops/osc/pallas_chain.py``. The hand-written CUDA
source ``pisa_tpu_torch/csrc/osc_chain.cu`` replaces all three Pallas
kernels:

- ``_chain_kernel`` (the primal) -> :func:`chain_probs`, plain version
  :func:`chain_probs_reference`;
- ``_chain_tangent_kernel`` (d probs / dt along one direction of the pack)
  -> :func:`chain_tangent`, plain version :func:`chain_tangent_reference`;
- ``_chain_multitangent_kernel`` (the primal and K tangents in one pass)
  -> :func:`chain_multitangent`, plain version
  :func:`chain_multitangent_reference`.

All three kernels are layer-parallel: over the static tile table of
:func:`tile_table` they build every real layer step's amplitude at once
(the tangent and the multitangent also its derivatives along their
directions) and then walk each chain through the stored amplitudes. The
multitangent splits its K directions into chunks over more threads.

CPU tensors go through the plain versions (vectorized torch over the point
axis; the tangents are ``torch.func.jvp`` of the primal); CUDA tensors
launch the kernels or raise.

Lanes: every function here also takes a leading lane axis on the pack and
its directions (B independent packs, the batched fits' lanes; what
``jax.vmap`` adds to the Pallas calls as a grid axis), and gives its outputs
the same leading axis. A launch serves all lanes, over the geometry and
tile table they share; the plain versions broadcast over lanes as over
points. Without the axis a call is the single-pack one, bit for bit.

What carries over from the JAX package is the math and its interfaces:

- the 57-scalar parameter pack (:func:`theta_to_pvec`, same layout as
  ``pallas_chain._unpack_params``), differentiable in theta;
- the sort by chain length (:func:`prepare_chain_geometry`), now with a
  per-point loop bound, the layer slabs laid out layer-major ``(L, N)`` and
  the tile table;
- output of only the nu_e / nu_mu initial-state rows, ``(2, 3, N)``, with
  the tau row from double stochasticity (:func:`tau_epilogue`);
- the gradient boundary at the six oscillation scalars
  (:func:`osc_probs`, the counterpart of ``_probs_pallas_fwdgrad_prep``):
  its backward forms the pack's Jacobian once and runs one tangent launch
  per active theta, or one multitangent launch for all of them; its jvp
  runs one tangent launch, and under ``torch.func.jacfwd`` (its vmap rule)
  one multitangent launch serves every direction;
- the general-pack route (:func:`osc_probs_general`, the counterpart of
  ``_probs_pallas_vjp`` :1042): any complex matter potential (NSI) and LRI
  potential, packed by :func:`pack_from_physics` and propagated by the
  primal kernel; its backward is reverse mode through the general
  formulation of ``kernels.py`` over the real layer steps, for the physics
  inputs only, as the JAX package's ``_vjp_bwd`` :1070 does; its jvp is
  the pack's tangent (:func:`pack_tangents`) through one tangent launch,
  and under ``torch.func.jacfwd`` K directions take ceil(K / 6)
  multitangent launches (the JAX package differentiates its XLA
  formulation in forward mode there); lanes of physics inputs are lanes of
  the launches.
"""

from __future__ import annotations

import ctypes
import os
import types

import numpy as np
import torch

from pisa_tpu_torch.ops.osc.kernels import _conj, _osc_probs
from pisa_tpu_torch.ops.osc.pmns import (
    dm_matrix,
    pmns_matrix,
    pmns_matrix_reparam,
)

__all__ = [
    "N_PACK",
    "theta_tensor",
    "theta_to_pvec",
    "pack_jacobian",
    "pack_from_physics",
    "prepare_chain_geometry",
    "tile_table",
    "TILE_STEPS",
    "TILE_POINTS",
    "chain_probs",
    "chain_probs_reference",
    "chain_tangent",
    "chain_tangent_reference",
    "chain_multitangent",
    "chain_multitangent_reference",
    "tau_epilogue",
    "osc_probs_prepared",
    "osc_probs",
    "OscProbs",
    "osc_probs_general",
    "OscProbsGeneral",
    "pack_tangents",
    "kernel_library",
    "launch_count",
    "tangent_launch_count",
    "multitangent_launch_count",
    "MAX_TANGENTS",
    "MAX_LANES",
    "chain_operations",
    "kernel_attributes",
]

N_PACK = 57
MAX_TANGENTS = 6  # multitangent K, dispatched to template instances 1..6
#: the most lanes of one launch (``csrc/osc_chain.cu`` kMaxLanes: the grid's
#: y dimension)
MAX_LANES = 65535
TWO_SQRT2_GF = 1.52588e-4  # 2*sqrt(2)*G_F in (eV^2 cm^3)/(mole GeV)
HBAR_C_FACTOR = 2.534  # (1/2)/(hbar c) in GeV/(eV^2 km)
_HALF_SQRT3 = 0.8660254037844386
#: Tile shape of the kernels: at most TILE_STEPS real layer steps and
#: TILE_POINTS points per tile (``csrc/osc_chain.cu`` kTileSteps,
#: kTilePoints).
TILE_STEPS = 128
TILE_POINTS = 64


def chain_operations(k=0, lanes=1):
    """Floating-point operations of one point's chain in ``csrc/osc_chain.cu``
    as ``(per point, per real layer step)``, for the primal (``k=0``) or a
    pass with k tangents, summed over `lanes` lanes (each does the same
    work on its own pack). Each add, subtract, multiply and divide counts
    one, and so does each sqrt, rsqrt, atan2 and sincos call; max, min,
    selects and negations count nothing. Counted by running ``chain_point``
    with an operation-counting scalar type (tests/test_torch_chain_source.py
    checks these numbers), so a launch does ``N * per_point + steps *
    per_step`` operations, with ``steps`` the points' layers of nonzero
    length."""
    if k == 0:
        return 217 * lanes, 473 * lanes
    return (217 + 318 * k) * lanes, (483 + 946 * k) * lanes


#: Numbers of CUDA kernel launches made in this process by
#: :func:`chain_probs`, :func:`chain_tangent` and :func:`chain_multitangent`
#: (each incremented where its kernel is launched, and nowhere else).
launch_count = 0
tangent_launch_count = 0
multitangent_launch_count = 0

_CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "osc_chain.cu",
)
_LIB = None


# -- parameter pack -------------------------------------------------------------
def pack_from_physics(dm_vac, U, mat_pot, lri_pot, nubar):
    """(dm_vac, U, mat_pot, lri_pot) -> packed (57,) real vector
    (``pallas_chain._pack_from_physics`` :1015 and ``_pack_params`` :622):
    U (re, im) | M_eff (re, im) | L_eff (re, im) | dm_vac[:, 0], with the
    matter and LRI terms rotated to the mass basis and the nubar sign folded
    in. `U` is the already-conjugated (for nubar) complex PMNS matrix. The
    inputs may carry leading lane axes ((B, 3, 3) each, or broadcastable
    against each other), which give (B, 57) packs."""
    sign = 1.0 if nubar > 0 else -1.0
    mp_eff = mat_pot if nubar > 0 else -_conj(mat_pot)
    Ud = _conj(U).transpose(-1, -2)
    M_eff = (Ud @ mp_eff) @ U
    lri = ((sign * 1e9) * lri_pot).to(U.dtype)
    L_eff = (Ud @ lri) @ U
    lead = torch.broadcast_shapes(M_eff.shape[:-2], L_eff.shape[:-2],
                                  dm_vac.shape[:-2])
    parts = [
        x.expand(lead + (3, 3)).reshape(lead + (9,)) for x in (
            U.real, U.imag, M_eff.real, M_eff.imag, L_eff.real, L_eff.imag)
    ]
    return torch.cat(parts + [dm_vac[..., :, 0].expand(lead + (3,))], dim=-1)



def theta_tensor(theta, device=None, lanes=None):
    """theta as a (6,) float64 tensor on `device` (by default that of its
    first tensor entry, else the CPU), or with `lanes` as a (lanes, 6) one,
    keeping the autograd graph of any tensor entries. Numbers are filled in
    on the device (a fill, not a copy from the host, so nothing waits and a
    stream capture takes it); with `lanes` every entry is spread over the
    lanes (a tensor entry holds one value per lane, or one for all)."""
    if isinstance(theta, torch.Tensor):
        return theta.to(torch.float64)
    if device is None:
        device = next((t.device for t in theta
                       if isinstance(t, torch.Tensor)), "cpu")
    shape = () if lanes is None else (lanes,)
    return torch.stack([
        t.to(torch.float64).reshape(-1).expand(shape) if lanes is not None
        and isinstance(t, torch.Tensor)
        else t.to(torch.float64) if isinstance(t, torch.Tensor)
        else torch.full(shape, float(t), dtype=torch.float64, device=device)
        for t in theta
    ], dim=-1)


def theta_to_pvec(theta, nubar, reparam=False, nlo_factor=1.0):
    """(theta12, theta13, theta23, deltacp [rad], dm21, dm31 [eV^2]) ->
    packed (57,) float64 vector for the standard matter path
    (``pallas_chain._build_standard`` :1114 + ``_theta_to_pvec`` :1238), on
    the device of `theta`; (B, 6) lanes of theta give (B, 57) packs.

    `theta` is a (6,) or (B, 6) tensor or a sequence of numbers and 0-d
    tensors; the pack is differentiable in every tensor entry."""
    theta = theta_tensor(theta)
    if theta.dim() == 2:
        return torch.func.vmap(
            lambda t: _theta_to_pvec(t, nubar, reparam, nlo_factor))(theta)
    return _theta_to_pvec(theta, nubar, reparam, nlo_factor)


def pack_jacobian(theta, nubar, reparam=False, nlo_factor=1.0):
    """d pack / d theta: (57, 6) at a (6,) theta, (B, 57, 6) at (B, 6)
    lanes (each lane's own block; no cross-lane blocks are formed)."""
    def jac(t):
        return torch.func.jacfwd(
            lambda u: _theta_to_pvec(u, nubar, reparam, nlo_factor))(t)

    theta = theta_tensor(theta).detach()
    if theta.dim() == 2:
        return torch.func.vmap(jac)(theta)
    return jac(theta)


def _theta_to_pvec(theta, nubar, reparam, nlo_factor):
    t12, t13, t23, dcp, dm21, dm31 = theta.unbind()
    fn = pmns_matrix_reparam if reparam else pmns_matrix
    mix = fn(torch.sin(t12), torch.sin(t13), torch.sin(t23), dcp)
    # the conjugate built explicitly: a lazily conjugated view has no vmap
    # rule for .imag, which torch.func.jacfwd of this function needs
    U = mix if nubar > 0 else torch.complex(mix.real, -mix.imag)
    dm_vac = dm_matrix(dm21, dm31)
    # the constants are filled in on theta's device, not copied to it
    mat_pot = torch.zeros((3, 3), dtype=torch.complex128, device=theta.device)
    mat_pot[0, 0].fill_(float(nlo_factor))
    lri_pot = torch.zeros((3, 3), dtype=torch.float64, device=theta.device)
    return pack_from_physics(dm_vac, U, mat_pot, lri_pot, nubar)


# -- geometry -------------------------------------------------------------------
def prepare_chain_geometry(energy, densities, distances, *, dtype, device,
                           general=False):
    """Every parameter-independent kernel input, computed once from the
    static (numpy) geometry: points sorted by chain length
    (``stages/osc/prob3.py:257-260``), the per-point layer-loop bound ``nl``
    (1 + index of the last nonzero-length layer), and the layer slabs laid
    out layer-major ``(L, N)``.

    Parameters
    ----------
    energy : (N,) array, GeV
    densities, distances : (N, L) arrays (zero-length slots are identity)
    general : also build ``slot_index``, which the general-pack route
        (:func:`osc_probs_general`) takes for its backward

    Returns a dict of tensors on `device`: ``e`` (N,), ``dens``/``dist``
    (L, N) in `dtype`, ``nl`` (N,) int32, ``order``/``inv`` (N,) int64,
    ``tiles``, the kernels' :func:`tile_table` of the sorted points, and,
    with `general`, ``slot_index`` (the flat indices of the nonzero-length
    slots of the sorted ``dist``, int64).
    """
    energy = np.asarray(energy, dtype=np.float64)
    densities = np.asarray(densities, dtype=np.float64)
    distances = np.asarray(distances, dtype=np.float64)
    real = distances > 0.0
    order = np.argsort(np.count_nonzero(real, axis=1), kind="stable")
    n_layers = distances.shape[1]
    nl = np.where(
        real.any(axis=1), n_layers - np.argmax(real[:, ::-1], axis=1), 0
    )

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    geom = {
        "e": put(energy[order], dtype),
        "dens": put(densities[order].T, dtype),
        "dist": put(distances[order].T, dtype),
        "nl": put(nl[order], torch.int32),
        "order": put(order, torch.int64),
        "inv": put(np.argsort(order), torch.int64),
        "tiles": tile_table(densities[order], distances[order], dtype=dtype,
                            device=device),
    }
    if general:
        geom["slot_index"] = put(
            np.flatnonzero(distances[order].T.ravel() > 0.0), torch.int64)
    return geom


def tile_table(densities, distances, *, dtype, device, steps=TILE_STEPS):
    """The layer-parallel kernels' static input: the points, in the given
    order, cut into tiles of at most `steps` real layer steps
    (``distance > 0``) and :data:`TILE_POINTS` points, never splitting a
    point; each point's real steps compacted, in chain order, into flat
    arrays. A point with no real step keeps its place in a tile (it gets
    the vacuum result).

    Parameters
    ----------
    densities, distances : (N, L) arrays, in the kernel's point order
    steps : the most steps of a tile (the wrappers take tables of
        :data:`TILE_STEPS` only, which the card's measurements favour; the
        multitangent kernel's entry point takes any, for those measurements)

    Returns a dict of tensors on `device`: ``tile`` (n_tiles, 4) int32 rows
    (first point, number of points, first step, number of steps);
    ``point_step`` (N + 1,) int32, point i's steps being
    ``point_step[i]:point_step[i + 1]``; per step, ``step_point`` int32 (its
    point's index within its tile) and ``rho``/``dx`` in `dtype`; and, on
    the host, ``steps``, the int32 scalar `steps` the table was cut to.
    """
    densities = np.asarray(densities, dtype=np.float64)
    distances = np.asarray(distances, dtype=np.float64)
    real = distances > 0.0
    counts = np.count_nonzero(real, axis=1)
    if counts.size and counts.max() > steps:
        raise ValueError(f"a chain of {counts.max()} layers exceeds the"
                         f" {steps} steps of a tile")
    n = counts.size
    point_step = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=point_step[1:])
    first = []
    start = filled = 0
    for i, c in enumerate(counts):
        if i - start == TILE_POINTS or filled + c > steps:
            first.append(start)
            start, filled = i, 0
        filled += c
    if n:
        first.append(start)
    first = np.asarray(first, dtype=np.int64)
    n_points = np.diff(np.append(first, n))
    first_step = point_step[first]
    n_steps = point_step[first + n_points] - first_step
    tile_of_point = np.repeat(np.arange(first.size), n_points)
    point_of_step = np.repeat(np.arange(n), counts)
    step_point = point_of_step - first[tile_of_point[point_of_step]]

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    return {
        "tile": put(np.stack([first, n_points, first_step, n_steps], axis=1)
                    .reshape(-1, 4), torch.int32),
        "point_step": put(point_step, torch.int32),
        "step_point": put(step_point, torch.int32),
        "rho": put(densities[real], dtype),
        "dx": put(distances[real], dtype),
        "steps": torch.tensor(steps, dtype=torch.int32),
    }


# -- the plain version ------------------------------------------------------------
def chain_probs_reference(pvec, e, dens, dist, nl):
    """The kernel's algorithm as vectorized torch: same inputs and output
    as :func:`chain_probs` ((2, 3, N) P(nu_a -> nu_b) for a in {e, mu}, or
    (B, 2, 3, N) for (B, 57) lanes of packs), a Python loop over layers and
    ``torch.where`` for zero-length or out-of-chain layers. Each scalar of
    the pack is kept with a trailing unit axis, so that it broadcasts over
    the points (and its lanes over theirs)."""
    lead = tuple(pvec.shape[:-1])
    p = pvec.to(e.dtype)[..., None]  # (..., 57, 1)

    def cmat(start):
        return torch.complex(p[..., start:start + 9, :],
                             p[..., start + 9:start + 18, :]).reshape(
                                 lead + (3, 3, 1))

    U, Me, Le = cmat(0), cmat(18), cmat(36)
    dm00, dm10, dm20 = p[..., 54, :], p[..., 55, :], p[..., 56, :]
    third = 1.0 / 3.0
    one_over_two_e = 0.5 / e
    two_e = 2.0 * e
    phase_s = -(1.0 / e) * HBAR_C_FACTOR

    def roots(scale, b, res, c2):
        cr, sr = torch.cos(res), torch.sin(res)
        return [
            two_e * (scale * (b * (-0.5 * cr - _HALF_SQRT3 * sr) - c2 * third)
                     + dm00),
            two_e * (scale * (b * (-0.5 * cr + _HALF_SQRT3 * sr) - c2 * third)
                     + dm00),
            two_e * (scale * (b * cr - c2 * third) + dm00),
        ]

    # vacuum-matched ordering masks (layer-invariant)
    scale_v = torch.clamp(
        torch.maximum(dm10.abs(), dm20.abs()) * one_over_two_e, min=1e-30
    )
    x = dm10 * one_over_two_e / scale_v
    y = dm20 * one_over_two_e / scale_v
    c2_v = -(x + y)
    p_v = x * x + y * y - x * y
    q_v = (x + y) * ((x + y) * (x + y) - 4.5 * x * y)
    tmp_v = torch.clamp(p_v * p_v * p_v - q_v * q_v, min=0.0)
    res_v = torch.atan2(torch.sqrt(tmp_v), q_v) * third
    m_v = roots(scale_v, (2.0 * third) * torch.sqrt(p_v), res_v, c2_v)
    picks = []
    for target in (dm00, dm10, dm20):
        d0, d1, d2 = ((target - mv).abs() for mv in m_v)
        picks.append((d1 < d0, d2 < torch.minimum(d0, d1)))

    def abs2(z):
        return z.real * z.real + z.imag * z.imag

    # states v[a, i] = conj(U[a, i]) in the mass basis, (..., 2, 3, N)
    V = U[..., :2, :, :].conj().expand(lead + (2, 3, e.shape[0])).clone()
    n_layers = int(nl.max()) if nl.numel() else 0
    for layer in range(n_layers):
        rho, dx = dens[layer], dist[layer]
        a = (0.5 * TWO_SQRT2_GF) * rho
        h01 = Me[..., 0, 1, :] * a + Le[..., 0, 1, :]
        h02 = Me[..., 0, 2, :] * a + Le[..., 0, 2, :]
        h12 = Me[..., 1, 2, :] * a + Le[..., 1, 2, :]
        h00 = Me[..., 0, 0, :].real * a + Le[..., 0, 0, :].real
        h11 = (Me[..., 1, 1, :].real * a + Le[..., 1, 1, :].real
               + dm10 * one_over_two_e)
        h22 = (Me[..., 2, 2, :].real * a + Le[..., 2, 2, :].real
               + dm20 * one_over_two_e)

        n01, n02, n12 = abs2(h01), abs2(h02), abs2(h12)
        scale2 = torch.maximum(
            torch.maximum(torch.maximum(h00 * h00, h11 * h11), h22 * h22),
            torch.maximum(torch.maximum(n01, n02), n12),
        ).clamp(min=1e-36)
        inv_s = torch.rsqrt(scale2)
        scale = scale2 * inv_s
        inv_s2 = inv_s * inv_s
        real_product_a = h01.real * (
            h12.real * h02.real + h12.imag * h02.imag
        ) - h01.imag * (h12.imag * h02.real - h12.real * h02.imag)
        c2 = -(h00 + h11 + h22) * inv_s
        c1 = (h00 * (h11 + h22) + h11 * h22 - n01 - n02 - n12) * inv_s2
        c0 = (
            (h00 * n12 + h11 * n02 + h22 * n01)
            - 2.0 * real_product_a
            - h00 * h11 * h22
        ) * (inv_s2 * inv_s)
        pp = torch.clamp(c2 * c2 - 3.0 * c1, min=0.0)
        qq = -13.5 * c0 - c2 * c2 * c2 + 4.5 * c1 * c2
        tmp = torch.clamp(
            27.0 * (0.25 * c1 * c1 * (pp - c1) + c0 * (qq + 6.75 * c0)),
            min=0.0,
        )
        res = torch.atan2(torch.sqrt(tmp), qq) * third
        m_u = roots(scale, (2.0 * third) * torch.sqrt(pp), res, c2)
        m = [
            torch.where(pick2, m_u[2], torch.where(pick1, m_u[1], m_u[0]))
            for pick1, pick2 in picks
        ]

        g = [h00 * two_e, h11 * two_e, h22 * two_e]
        g01, g02, g12 = h01 * two_e, h02 * two_e, h12 * two_e
        n01g, n02g, n12g = abs2(g01), abs2(g02), abs2(g12)
        x01 = g02 * g12.conj()
        x02 = g01 * g12
        x12 = g01.conj() * g02

        def projector(ma, mb):
            a00, a11, a22 = g[0] - ma, g[1] - ma, g[2] - ma
            b00, b11, b22 = g[0] - mb, g[1] - mb, g[2] - mb
            return (
                a00 * b00 + n01g + n02g,
                a11 * b11 + n01g + n12g,
                a22 * b22 + n02g + n12g,
                g01 * (a00 + b11) + x01,
                g02 * (a00 + b22) + x02,
                g12 * (a11 + b22) + x12,
            )

        pr1 = projector(m[0], m[2])
        pr2 = projector(m[0], m[1])
        d01 = m[0] - m[1]
        d02 = m[0] - m[2]
        d12 = m[1] - m[2]
        r = 1.0 / (d01 * d02 * d12)
        inv1 = -d02 * r
        inv2 = d01 * r
        s = phase_s * dx
        ar1 = -d01 * s
        ar2 = -d02 * s
        w1 = torch.complex((torch.cos(ar1) - 1.0) * inv1, torch.sin(ar1) * inv1)
        w2 = torch.complex((torch.cos(ar2) - 1.0) * inv2, torch.sin(ar2) * inv2)

        def tdiag(k):
            return w1 * pr1[k] + w2 * pr2[k] + 1.0

        def toffd(k, conjugate=False):
            if conjugate:
                return w1 * pr1[k].conj() + w2 * pr2[k].conj()
            return w1 * pr1[k] + w2 * pr2[k]

        T = torch.stack(
            [
                torch.stack([tdiag(0), toffd(3), toffd(4)], dim=-2),
                torch.stack([toffd(3, True), tdiag(1), toffd(5)], dim=-2),
                torch.stack([toffd(4, True), toffd(5, True), tdiag(2)],
                            dim=-2),
            ],
            dim=-3,
        )  # (..., 3, 3, N)
        # newV[a, i] = sum_k T[i, k] V[a, k]
        newV = (T[..., None, :, :, :] * V[..., :, None, :, :]).sum(dim=-2)
        keep = (dx > 0.0) & (layer < nl)
        V = torch.where(keep, newV, V)

    # F[a, b] = sum_i U[b, i] V[a, i]
    F = (U[..., None, :, :, :] * V[..., :, None, :, :]).sum(dim=-2)
    return abs2(F)


def _jvps_reference(pvec, dpvecs, e, dens, dist, nl):
    """The primal of :func:`chain_probs_reference` and its derivatives
    along the pack directions `dpvecs` (K, 57), (K, 2, 3, N); with lanes,
    pvec (B, 57) and dpvecs (B, K, 57) give (B, 2, 3, N) and
    (B, K, 2, 3, N).

    On the card: forward mode (``torch.func.jvp``, batched over the
    directions by ``torch.func.vmap``). On the CPU, where forward-mode
    transforms of the layer loop run its complex ops through Python
    decompositions, two reverse passes per direction take a third of the
    time: with the cotangent u a free variable, g(u) = J^T u is linear, and
    the gradient of <g(u), d> in u is J d. Inside a ``torch.func``
    transform (``jacrev`` runs the backward under ``vmap``), where autograd
    cannot be called, forward mode serves on the CPU too."""
    dpvecs = dpvecs.to(pvec.dtype)
    lanes_axis = pvec.dim() - 1  # where the directions' axis goes
    if (pvec.device.type != "cpu"
            or torch._C._are_functorch_transforms_active()):
        primals, tangents = torch.func.vmap(
            lambda d: torch.func.jvp(
                lambda p: chain_probs_reference(p, e, dens, dist, nl),
                (pvec,), (d,),
            ),
            in_dims=lanes_axis,
        )(dpvecs)
        return primals[0], tangents.movedim(0, lanes_axis)
    point = pvec.detach().requires_grad_(True)
    with torch.enable_grad():
        # lanes are independent: the gradient of the lanes' sum is each
        # lane's own J^T u
        primal = chain_probs_reference(point, e, dens, dist, nl)
        u = torch.zeros_like(primal, requires_grad=True)
        (g,) = torch.autograd.grad(primal, point, u, create_graph=True)
        tangents = [torch.autograd.grad(g, u, d, retain_graph=True)[0]
                    for d in dpvecs.unbind(lanes_axis)]
    return primal.detach(), torch.stack(tangents, dim=lanes_axis)


def chain_tangent_reference(pvec, dpvec, e, dens, dist, nl):
    """d(probs)/dt along the pack direction `dpvec`: the directional
    derivative of :func:`chain_probs_reference` in its pack. Same inputs as
    the primal plus `dpvec` (57,) (lanes: (B, 57)); returns (2, 3, N)
    ((B, 2, 3, N))."""
    if (pvec.device.type != "cpu"
            or torch._C._are_functorch_transforms_active()):
        return torch.func.jvp(
            lambda p: chain_probs_reference(p, e, dens, dist, nl),
            (pvec,), (dpvec.to(pvec.dtype),),
        )[1]
    axis = pvec.dim() - 1
    return _jvps_reference(pvec, dpvec.unsqueeze(axis), e, dens, dist,
                           nl)[1].select(axis, 0)


def chain_multitangent_reference(pvec, dpvecs, e, dens, dist, nl):
    """The primal (2, 3, N) and its derivatives along the K pack directions
    `dpvecs` (K, 57), stacked (K, 2, 3, N); lanes: (B, 57) and (B, K, 57)
    give (B, 2, 3, N) and (B, K, 2, 3, N)."""
    return _jvps_reference(pvec, dpvecs, e, dens, dist, nl)


# -- the kernels -----------------------------------------------------------------
# One library per kernel, each compiled from osc_chain.cu with one part
# selected, so that the three build in parallel.
_PARTS = {
    "osc_chain": "-DOSC_CHAIN_PRIMAL",
    "osc_chain_tangent": "-DOSC_CHAIN_TANGENT",
    "osc_chain_multitangent": "-DOSC_CHAIN_MULTITANGENT",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # pvec, tile, point_step, step_point, rho, dx, e, out, n_tiles, n,
    # lanes, stream
    "osc_chain": [_P] * 8 + [_I, _I, _I, _P],
    # pvec, dpvec, tile, point_step, step_point, rho, dx, e, dout, n_tiles,
    # n, lanes, stream
    "osc_chain_tangent": [_P] * 9 + [_I, _I, _I, _P],
    # pvec, dpvecs, k, tile, point_step, step_point, rho, dx, e, out, dout,
    # n_tiles, n, tile_steps, lanes, stream
    "osc_chain_multitangent": [_P, _P, _I] + [_P] * 8 + [_I] * 4 + [_P],
}


def kernel_library():
    """The kernels' entry points (ctypes functions ``osc_chain_f32``,
    ``osc_chain_tangent_f64``, ..., and ``osc_chain_attributes_f32``, ...),
    built from ``csrc/osc_chain.cu`` at first use
    (``utils/cuda_build.py``)."""
    global _LIB
    if _LIB is None:
        from pisa_tpu_torch.utils.cuda_build import build_libraries

        libs = build_libraries(
            {name: ([_CSRC], [flag]) for name, flag in _PARTS.items()}
        )
        fns = {}
        for name, lib in libs.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                fns[f"{name}_{suffix}"] = fn
                attrs = getattr(lib, f"{name}_attributes_{suffix}")
                attrs.argtypes = [_I, _I, _P]
                attrs.restype = ctypes.c_int
                fns[f"{name}_attributes_{suffix}"] = attrs
        _LIB = types.SimpleNamespace(**fns)
    return _LIB


def kernel_attributes(name, dtype, k=1):
    """Resources of kernel `name` (``osc_chain``, ``osc_chain_tangent``,
    ``osc_chain_multitangent`` with `k` tangents) in `dtype` on the current
    card: registers per thread, local-memory bytes per thread (stack frame
    and spills), shared bytes per block, threads per block and resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); for
    the multitangent also ``c1`` and ``c2``, the directions per thread of
    its phases 1 and 2."""
    suffix = "f64" if dtype == torch.float64 else "f32"
    fn = getattr(kernel_library(), f"{name}_attributes_{suffix}")
    info = (ctypes.c_int * 7)()
    rc = fn(int(k), TILE_STEPS, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"{name} attributes: CUDA error {rc}")
    keys = ("registers", "local_bytes", "shared_bytes", "threads",
            "blocks_per_sm", "c1", "c2")
    n_keys = 7 if name == "osc_chain_multitangent" else 5
    return dict(zip(keys[:n_keys], info))


def _check_inputs(pvec, e, dens, dist, nl):
    """Checks the inputs; returns the lanes' leading shape, () or (B,)."""
    if e.dtype not in (torch.float32, torch.float64) or e.dim() != 1:
        raise ValueError(f"energy must be (N,) float32/float64; got {e.dtype}"
                         f" {tuple(e.shape)}")
    n = e.shape[0]
    if (pvec.dim() not in (1, 2) or pvec.shape[-1] != N_PACK
            or pvec.dtype != e.dtype):
        raise ValueError(f"pvec must be ({N_PACK},) or (B, {N_PACK})"
                         f" {e.dtype}; got {pvec.dtype} {tuple(pvec.shape)}")
    lead = tuple(pvec.shape[:-1])
    if lead and not 1 <= lead[0] <= MAX_LANES:
        raise ValueError(f"{lead[0]} lanes: a launch takes 1 to {MAX_LANES}"
                         " (the grid's y limit); split the batch")
    if dens.dim() != 2 or dens.shape != dist.shape or dens.shape[1] != n:
        raise ValueError(f"dens/dist must be (L, {n}); got"
                         f" {tuple(dens.shape)}, {tuple(dist.shape)}")
    if dens.dtype != e.dtype or dist.dtype != e.dtype:
        raise ValueError("dens/dist must have the energy's dtype")
    if nl.shape != (n,) or nl.dtype != torch.int32:
        raise ValueError(f"nl must be ({n},) int32; got {nl.dtype}"
                         f" {tuple(nl.shape)}")
    devices = {t.device for t in (pvec, e, dens, dist, nl)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    return lead


def _check_directions(name, d, shape, e):
    if d.shape != shape or d.dtype != e.dtype or d.device != e.device:
        raise ValueError(f"{name} must be {shape} {e.dtype} on {e.device};"
                         f" got {d.dtype} {tuple(d.shape)} on {d.device}")


_TILE_KEYS = ("tile", "point_step", "step_point", "rho", "dx")


def _tile_args(name, tiles, e):
    """The tile table's tensors in launch order, checked against `e`; a
    launch needs the table that :func:`prepare_chain_geometry` built."""
    if tiles is None:
        raise ValueError(f"{name} on {e.device} needs the tile table of"
                         " prepare_chain_geometry (geom['tiles'])")
    t = [tiles[k] for k in _TILE_KEYS]
    n = e.shape[0]
    steps = t[2].shape[0]
    ok = (
        t[0].dim() == 2 and t[0].shape[1] == 4
        and t[1].shape == (n + 1,)
        and all(x.dtype == torch.int32 for x in t[:3])
        and t[3].shape == t[4].shape == (steps,)
        and t[3].dtype == t[4].dtype == e.dtype
        and all(x.device == e.device and x.is_contiguous() for x in t)
    )
    if not ok:
        raise ValueError(f"{name}: tile table does not fit {n} points of"
                         f" {e.dtype} on {e.device}")
    if int(tiles["steps"]) != TILE_STEPS:
        raise ValueError(f"{name}: tile table cut to {int(tiles['steps'])}"
                         f" steps a tile, not {TILE_STEPS}")
    return t


def _on_card(name, e, tensors):
    """False for CPU tensors (the plain version runs); True for contiguous
    CUDA tensors (the kernel launches); raises otherwise."""
    if e.device.type == "cpu":
        return False
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    return True


def _launch(name, e, *args):
    """Launch entry point `name` (float32/float64 by `e`) on the current
    stream of `e`'s card; tensors are passed as their data pointers."""
    suffix = "f64" if e.dtype == torch.float64 else "f32"
    fn = getattr(kernel_library(), f"{name}_{suffix}")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _n_lanes(lead):
    return lead[0] if lead else 1


def chain_probs(pvec, e, dens, dist, nl, tiles=None):
    """P(nu_a -> nu_b) through each point's layer chain, (2, 3, N) for
    a in {e, mu}, b in {e, mu, tau}; for (B, 57) lanes of packs, (B, 2, 3,
    N) from one launch.

    pvec (57,) or (B, 57), e (N,), dens/dist (L, N) layer-major, all of one
    float dtype; nl (N,) int32 per-point loop bounds (``nl[i] <= L``);
    `tiles` the same points' :func:`tile_table`. CPU tensors go through
    :func:`chain_probs_reference` (which needs no tile table); CUDA tensors
    launch the CUDA kernel over the tile table or raise."""
    global launch_count
    lead = _check_inputs(pvec, e, dens, dist, nl)
    if not _on_card("chain_probs", e, (pvec, e, dens, dist, nl)):
        return chain_probs_reference(pvec, e, dens, dist, nl)
    t = _tile_args("chain_probs", tiles, e)
    n = e.shape[0]
    out = torch.empty(lead + (2, 3, n), dtype=e.dtype, device=e.device)
    _launch("osc_chain", e, pvec, *t, e, out, t[0].shape[0], n,
            _n_lanes(lead))
    launch_count += 1
    return out


def chain_tangent(pvec, dpvec, e, dens, dist, nl, tiles=None):
    """d P(nu_a -> nu_b) / dt along the pack direction `dpvec` (57,),
    (2, 3, N); with lanes, pvec and dpvec (B, 57) give (B, 2, 3, N) from
    one launch. The other inputs as for :func:`chain_probs`. CPU tensors go
    through :func:`chain_tangent_reference`; CUDA tensors launch the CUDA
    tangent kernel over the tile table or raise."""
    global tangent_launch_count
    lead = _check_inputs(pvec, e, dens, dist, nl)
    _check_directions("dpvec", dpvec, lead + (N_PACK,), e)
    if not _on_card("chain_tangent", e, (pvec, dpvec, e, dens, dist, nl)):
        return chain_tangent_reference(pvec, dpvec, e, dens, dist, nl)
    t = _tile_args("chain_tangent", tiles, e)
    n = e.shape[0]
    dout = torch.empty(lead + (2, 3, n), dtype=e.dtype, device=e.device)
    _launch("osc_chain_tangent", e, pvec, dpvec, *t, e, dout, t[0].shape[0],
            n, _n_lanes(lead))
    tangent_launch_count += 1
    return dout


def chain_multitangent(pvec, dpvecs, e, dens, dist, nl, tiles=None):
    """The primal (2, 3, N) and its tangents along the K pack directions
    `dpvecs` (K, 57), 1 <= K <= 6, as (K, 2, 3, N), in one pass; with
    lanes, pvec (B, 57) and dpvecs (B, K, 57) give (B, 2, 3, N) and (B, K,
    2, 3, N) from one launch. The other inputs as for :func:`chain_probs`.
    CPU tensors go through :func:`chain_multitangent_reference`; CUDA
    tensors launch the CUDA multitangent kernel over the tile table or
    raise."""
    global multitangent_launch_count
    lead = _check_inputs(pvec, e, dens, dist, nl)
    k = dpvecs.shape[-2] if dpvecs.dim() == len(lead) + 2 else 0
    if not 1 <= k <= MAX_TANGENTS:
        raise ValueError(f"dpvecs must hold 1..{MAX_TANGENTS} directions;"
                         f" got shape {tuple(dpvecs.shape)}")
    _check_directions("dpvecs", dpvecs, lead + (k, N_PACK), e)
    if not _on_card("chain_multitangent", e, (pvec, dpvecs, e, dens, dist, nl)):
        return chain_multitangent_reference(pvec, dpvecs, e, dens, dist, nl)
    t = _tile_args("chain_multitangent", tiles, e)
    n = e.shape[0]
    out = torch.empty(lead + (2, 3, n), dtype=e.dtype, device=e.device)
    dout = torch.empty(lead + (k, 2, 3, n), dtype=e.dtype, device=e.device)
    _launch("osc_chain_multitangent", e, pvec, dpvecs, k, *t, e, out, dout,
            t[0].shape[0], n, TILE_STEPS, _n_lanes(lead))
    multitangent_launch_count += 1
    return out, dout


def tau_epilogue(p2):
    """(..., 2, 3, N) nu_e/nu_mu initial-state rows -> (..., N, 3, 3) with
    the tau row from double stochasticity (``pallas_chain._tau_epilogue``
    :821)."""
    tau = torch.clamp(1.0 - p2[..., 0, :, :] - p2[..., 1, :, :], min=0.0)
    return torch.cat([p2, tau.unsqueeze(-3)], dim=-3).movedim(-1, -3)


def _tau_row_tangent(p2, dp2):
    """Tangent of :func:`tau_epilogue`'s tau row for the primal p2
    (..., 2, 3, N) and its K raw tangents dp2 (..., K, 2, 3, N):
    (..., K, 3, N). As ``jnp.maximum``'s jvp, an exact tie at the clamp
    takes half the tangent."""
    tau = (1.0 - p2[..., 0, :, :] - p2[..., 1, :, :]).unsqueeze(-3)
    d = -dp2[..., 0, :, :] - dp2[..., 1, :, :]
    return torch.where(tau > 0, d, torch.where(tau == 0, 0.5 * d, torch.zeros_like(d)))


def osc_probs_prepared(pvec, geom):
    """One propagation over :func:`prepare_chain_geometry` output: (N, 3, 3)
    probabilities ``probs[i, a, b] = P(nu_a -> nu_b)`` in the original point
    order (the counterpart of ``chain_probs_pallas_prepared`` :803); (B, 57)
    lanes of packs give (B, N, 3, 3)."""
    p2 = chain_probs(pvec, geom["e"], geom["dens"], geom["dist"], geom["nl"],
                     geom["tiles"])
    return tau_epilogue(p2).index_select(-3, geom["inv"])


# -- the gradient boundary ------------------------------------------------------------
def _probs_tangents(theta, dthetas, p2, pvec, geom, pack_args, active,
                    multitangent):
    """The probabilities' tangents (..., K, N, 3, 3), in the original point
    order, along the K directions `dthetas` (..., K, 6) of theta (..., 6),
    whose primal `p2` and pack `pvec` are given. A direction's inactive
    components count as zero. One direction is one tangent launch along
    the pack Jacobian's product with it. More are one multitangent launch:
    along the directions themselves where they are fewer than the active
    components, else along the active columns of the Jacobian, whose
    tangents the directions then combine (the tangent is linear in its
    direction). With `multitangent` off, one tangent launch per direction
    taken."""
    ks = list(active)
    k = dthetas.shape[-2]
    if not ks:
        n = geom["e"].shape[0]
        return dthetas.new_zeros(dthetas.shape[:-1] + (n, 3, 3))
    jac = pack_jacobian(theta, *pack_args)[..., ks].to(pvec.dtype)  # (.., 57, A)
    d_act = dthetas[..., ks].to(pvec.dtype)  # (..., K, A)
    combine = 1 < k and len(ks) <= k
    if combine:
        dpvecs = jac.transpose(-1, -2)  # (..., A, 57): the active columns
    else:
        dpvecs = d_act @ jac.transpose(-1, -2)  # (..., K, 57)
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    if multitangent and dpvecs.shape[-2] > 1:
        dp2s = chain_multitangent(pvec, dpvecs.contiguous(), *args,
                                  geom["tiles"])[1]
    else:
        dp2s = torch.stack(
            [chain_tangent(pvec, d.contiguous(), *args, geom["tiles"])
             for d in dpvecs.unbind(-2)], dim=-4)  # (..., K|A, 2, 3, N)
    dprobs = torch.cat([dp2s, _tau_row_tangent(p2, dp2s).unsqueeze(-3)],
                       dim=-3)  # (..., K|A, 3, 3, N)
    if combine:
        dprobs = torch.einsum("...ka,...afbn->...kfbn", d_act, dprobs)
    return dprobs.movedim(-1, -3).index_select(-3, geom["inv"])


class OscProbs(torch.autograd.Function):
    """theta (6,) -> (N, 3, 3) probabilities over prepared geometry, with the
    gradient of ``pallas_chain._probs_pallas_fwdgrad_prep`` (:1227-1324) in
    both modes; (B, 6) lanes of theta -> (B, N, 3, 3), through the same
    launches as one theta. Everything happens on the geometry's device,
    where `theta` must lie: nothing is copied from or to the host, so no
    pass waits for the card and each can be captured in a CUDA graph.

    forward: the pack from theta (float64, cast to the geometry's type), one
    primal launch, the tau row and the unsort. backward: the pack's 57x6
    Jacobian (``torch.func.jacfwd``, there and then; per lane, with no
    cross-lane blocks), one tangent launch per active theta component or
    one multitangent launch for all of them; each tangent goes through the
    tau row's derivative and is contracted with the cotangent in sorted
    order. jvp: the tangent along one direction of theta, by
    :class:`_OscProbsTangent` (one tangent launch), whose vmap rule makes K
    directions (``torch.func.jacfwd``) one multitangent launch. vmap: a
    batch of thetas runs as lanes. Inactive components get zero gradient
    and zero tangent. The geometry gets none."""

    @staticmethod
    def forward(theta, geom, nubar, reparam, nlo_factor, active,
                multitangent):
        e = geom["e"]
        if theta.device != e.device:
            raise ValueError(f"theta lies on {theta.device}, the geometry on"
                             f" {e.device}")
        pvec = theta_to_pvec(theta, nubar, reparam, nlo_factor).to(e.dtype)
        p2 = chain_probs(pvec, e, geom["dens"], geom["dist"], geom["nl"],
                         geom["tiles"])
        return tau_epilogue(p2).index_select(-3, geom["inv"]), p2, pvec

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, geom, nubar, reparam, nlo_factor, active, multitangent = inputs
        _, p2, pvec = output
        ctx.mark_non_differentiable(p2, pvec)
        ctx.save_for_backward(theta, p2, pvec)
        ctx.save_for_forward(theta, p2, pvec)
        ctx.geom = geom
        ctx.pack_args = (nubar, reparam, nlo_factor)
        ctx.active = active
        ctx.multitangent = multitangent

    @staticmethod
    def backward(ctx, g, _g_p2, _g_pvec):
        theta, p2, pvec = ctx.saved_tensors
        geom = ctx.geom
        ks = ctx.active
        if not ks:
            return (torch.zeros_like(theta),) + (None,) * 6
        nubar, reparam, nlo_factor = ctx.pack_args
        jac = pack_jacobian(theta, nubar, reparam, nlo_factor)  # (..., 57, 6)
        # the active columns, picked by Python ints: views, no index tensor
        dpvecs = torch.stack([jac[..., k] for k in ks], dim=-2).to(
            pvec.dtype)  # (..., K, 57)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        if ctx.multitangent:
            _, dp2s = chain_multitangent(pvec, dpvecs, *args, geom["tiles"])
        else:
            dp2s = torch.stack(
                [chain_tangent(pvec, d.contiguous(), *args, geom["tiles"])
                 for d in dpvecs.unbind(-2)], dim=-4)
        # probs = probs_sorted[inv]  =>  the sorted cotangent is g[order]
        g_s = g.index_select(-3, geom["order"]).movedim(-3, -1)  # (.., 3, 3, N)
        grads = ((g_s[..., None, :2, :, :] * dp2s).sum(dim=(-3, -2, -1)) + (
            g_s[..., None, 2, :, :] * _tau_row_tangent(p2, dp2s)
        ).sum(dim=(-2, -1))).to(theta.dtype)  # (..., K)
        zero = torch.zeros(grads.shape[:-1], dtype=theta.dtype,
                           device=theta.device)
        dtheta = torch.stack([
            grads[..., ks.index(i)] if i in ks else zero for i in range(6)
        ], dim=-1)
        return (dtheta,) + (None,) * 6

    @staticmethod
    def jvp(ctx, dtheta, *_):
        theta, p2, pvec = ctx.saved_tensors
        dprobs = _OscProbsTangent.apply(theta, dtheta, p2, pvec, ctx.geom,
                                        ctx.pack_args, ctx.active,
                                        ctx.multitangent)
        return dprobs, None, None

    @staticmethod
    def vmap(info, in_dims, theta, geom, nubar, reparam, nlo_factor, active,
             multitangent):
        # a batch of thetas (each (6,) or (B, 6) lanes) is one run of lanes
        theta = theta.movedim(in_dims[0], 0)
        lead = tuple(theta.shape[:-1])
        outputs = OscProbs.apply(theta.reshape(-1, 6), geom, nubar, reparam,
                                 nlo_factor, active, multitangent)
        return tuple(x.reshape(lead + tuple(x.shape[1:]))
                     for x in outputs), (0, 0, 0)


class _OscProbsTangent(torch.autograd.Function):
    """The tangent of :class:`OscProbs`'s probabilities along one direction
    `dtheta` of theta (one tangent launch); its vmap rule takes a batch of
    directions at one theta (``torch.func.jacfwd``) as one multitangent
    launch (:func:`_probs_tangents`), and a batch of thetas as lanes. It is
    a forward-mode rule and has no backward."""

    @staticmethod
    def forward(theta, dtheta, p2, pvec, geom, pack_args, active,
                multitangent):
        return _probs_tangents(theta, dtheta.unsqueeze(-2), p2, pvec, geom,
                               pack_args, active, multitangent).squeeze(-4)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, theta, dtheta, p2, pvec, geom, pack_args, active,
             multitangent):
        t_dim, d_dim, p2_dim, pv_dim = in_dims[:4]
        args = (geom, pack_args, active, multitangent)
        if t_dim is None and p2_dim is None and pv_dim is None:
            # K directions at one theta: (..., K, 6)
            dthetas = dtheta.movedim(d_dim, -2)
            out = _probs_tangents(theta, dthetas, p2, pvec, *args)
            return out, out.dim() - 4
        # a batch of thetas, each with its direction: lanes of one launch
        # (merged with the lanes the thetas carry already, if any)
        size = info.batch_size
        lead = tuple(theta.shape[:-1] if t_dim is None
                     else theta.movedim(t_dim, 0).shape[1:-1])
        n = p2.shape[-1]
        theta, dtheta, p2, pvec = _as_lanes(
            [(theta, (6,)), (dtheta, (6,)), (p2, (2, 3, n)),
             (pvec, (N_PACK,))], in_dims[:4], size, lead)
        out = _probs_tangents(theta, dtheta.unsqueeze(-2), p2, pvec,
                              *args).squeeze(-4)
        return out.reshape((size,) + lead + tuple(out.shape[1:])), 0


def osc_probs(theta, nubar, geom, reparam=False, nlo_factor=1.0,
              active=None, multitangent=True):
    """Standard-path propagation over :func:`prepare_chain_geometry` output,
    differentiable in ``theta`` = (theta12, theta13, theta23, deltacp [rad],
    dm21, dm31 [eV^2]): (N, 3, 3) probabilities in the original point order
    (the counterpart of ``osc_probs_layers_pallas_fwdgrad_prepared``
    :1431).

    `theta` is a (6,) tensor or a sequence of numbers and 0-d tensors (the
    parameter magnitudes), on the geometry's device, or a (B, 6) tensor of
    lanes, which gives (B, N, 3, 3) from the launches of one theta.
    `active` (indices into
    theta, default all) selects the components whose tangents the backward
    computes; the others get zero gradient. `multitangent` (the default, as
    ``prob3``'s) computes them in one multitangent launch; ``False`` in one
    tangent launch each."""
    theta = theta_tensor(theta, device=geom["e"].device)
    active = tuple(range(6)) if active is None else tuple(int(i) for i in active)
    return OscProbs.apply(theta, geom, int(nubar), bool(reparam),
                          float(nlo_factor), active, bool(multitangent))[0]


# -- the general-pack route -----------------------------------------------------
def pack_tangents(physics, tangents, nubar):
    """The pack's tangent along the physics inputs' tangents: the jvp of
    :func:`pack_from_physics` (``torch.func.jvp``; the pack is bilinear in
    U and the potentials). `physics` and `tangents` are the four inputs and
    their tangents (None: zero), broadcastable against each other; every
    leading axis of either is the result's: (..., 57), float64."""
    lead = torch.broadcast_shapes(*(x.shape[:-2] for x in physics + tuple(
        t for t in tangents if t is not None)))
    # dual tensors need their own memory: the broadcasts are copied
    primals = tuple(x.expand(lead + (3, 3)).contiguous() for x in physics)
    dirs = tuple(torch.zeros_like(x) if t is None
                 else t.expand(lead + (3, 3)).contiguous()
                 for x, t in zip(primals, tangents))
    return torch.func.jvp(
        lambda *p: pack_from_physics(*p, nubar), primals, dirs)[1]


def _general_tangents(p2, pvec, dpvecs, geom):
    """The probabilities' tangents (..., K, N, 3, 3), in the original point
    order, along the K pack directions `dpvecs` (..., K, 57) at the pack
    `pvec` (..., 57) with primal `p2`: one direction is one tangent launch,
    more are ceil(K / MAX_TANGENTS) multitangent launches."""
    args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
    dpvecs = dpvecs.to(pvec.dtype)
    if dpvecs.shape[-2] == 1:
        dp2s = chain_tangent(pvec, dpvecs[..., 0, :].contiguous(), *args,
                             geom["tiles"]).unsqueeze(-4)
    else:
        dp2s = torch.cat([
            chain_multitangent(pvec, chunk.contiguous(), *args,
                               geom["tiles"])[1]
            for chunk in dpvecs.split(MAX_TANGENTS, dim=-2)], dim=-4)
    dprobs = torch.cat([dp2s, _tau_row_tangent(p2, dp2s).unsqueeze(-3)],
                       dim=-3)  # (..., K, 3, 3, N)
    return dprobs.movedim(-1, -3).index_select(-3, geom["inv"])


def _as_lanes(tensors, dims, size, lead):
    """Each tensor (or None) with its vmap axis `dim` first, expanded to
    (size,) + `lead` + its trailing `tail` and merged into one lane axis;
    `tensors` holds (tensor, tail) pairs."""
    out = []
    for (x, tail), dim in zip(tensors, dims):
        if x is None:
            out.append(None)
            continue
        x = x.movedim(dim, 0) if dim is not None else x.expand(
            (size,) + tuple(x.shape))
        out.append(x.expand((size,) + lead + tail).reshape((-1,) + tail)
                   .contiguous())
    return out


class OscProbsGeneral(torch.autograd.Function):
    """(dm_vac, U, mat_pot, lri_pot) -> (N, 3, 3) probabilities over
    ``prepare_chain_geometry(..., general=True)`` output, for any complex matter potential
    (NSI) and LRI potential (``pallas_chain._probs_pallas_vjp`` :1042 with
    ``_vjp_fwd``/``_vjp_bwd``). `U` is the already-conjugated (for nubar)
    complex PMNS matrix, all four in float64 on the geometry's device, each
    (3, 3) or (B, 3, 3) lanes, which give (B, N, 3, 3) from one launch.

    forward: the pack (:func:`pack_from_physics`, cast to the geometry's
    type), one primal launch, the tau row and the unsort. backward: the
    propagation again by the general formulation
    (``kernels._osc_probs``) over the real layer steps of the sorted
    geometry (``geom["slot_index"]``), in the geometry's type, over the same
    lanes, and reverse mode through it for the physics inputs only; the
    geometry gets no gradient. jvp: the pack's tangent
    (:func:`pack_tangents`) and one tangent launch, by
    :class:`_OscProbsGeneralTangent`, whose vmap rule makes K directions
    (``torch.func.jacfwd``) ceil(K / 6) multitangent launches, the
    counterpart of ``jax.jacfwd`` through ``_osc_probs_xla``. vmap: a batch
    of physics inputs runs as lanes of one launch. Nothing is read on the
    host, so a CUDA graph captures each of them."""

    @staticmethod
    def forward(dm_vac, U, mat_pot, lri_pot, geom, nubar):
        e = geom["e"]
        if U.device != e.device:
            raise ValueError(f"the physics inputs lie on {U.device}, the"
                             f" geometry on {e.device}")
        pvec = pack_from_physics(dm_vac, U, mat_pot, lri_pot, nubar).to(
            e.dtype)
        p2 = chain_probs(pvec, e, geom["dens"], geom["dist"], geom["nl"],
                         geom["tiles"])
        return tau_epilogue(p2).index_select(-3, geom["inv"]), p2, pvec

    @staticmethod
    def setup_context(ctx, inputs, output):
        dm_vac, U, mat_pot, lri_pot, geom, nubar = inputs
        _, p2, pvec = output
        ctx.mark_non_differentiable(p2, pvec)
        ctx.save_for_backward(dm_vac, U, mat_pot, lri_pot)
        ctx.save_for_forward(dm_vac, U, mat_pot, lri_pot, p2, pvec)
        ctx.geom = geom
        ctx.nubar = nubar

    @staticmethod
    def backward(ctx, g, _g_p2, _g_pvec):
        geom = ctx.geom
        e = geom["e"]
        cplx = torch.complex64 if e.dtype == torch.float32 else torch.complex128
        wanted = ctx.needs_input_grad[:4]
        saved = ctx.saved_tensors

        def propagate(*free):
            # the wanted inputs from `free`, the others as saved
            free = iter(free)
            dm_vac, U, mat_pot, lri_pot = (
                next(free) if w else x for x, w in zip(saved, wanted))
            return _osc_probs(
                dm_vac.to(e.dtype), U.to(cplx), mat_pot.to(cplx), None,
                lri_pot.to(e.dtype), ctx.nubar, e, geom["dens"].T,
                geom["dist"].T, slot_index=geom["slot_index"])

        # torch.func.vjp, not autograd.grad: torch.func.jacrev runs this
        # backward under vmap
        _, pullback = torch.func.vjp(
            propagate, *(x for x, w in zip(saved, wanted) if w))
        # probs = probs_sorted[inv]  =>  the sorted cotangent is g[order]
        grads = iter(pullback(g.index_select(-3, geom["order"])))
        return tuple(next(grads) if w else None for w in wanted) + (None, None)

    @staticmethod
    def jvp(ctx, ddm_vac, dU, dmat_pot, dlri_pot, *_):
        dprobs = _OscProbsGeneralTangent.apply(
            *ctx.saved_tensors, ddm_vac, dU, dmat_pot, dlri_pot, ctx.geom,
            ctx.nubar)
        return dprobs, None, None

    @staticmethod
    def vmap(info, in_dims, dm_vac, U, mat_pot, lri_pot, geom, nubar):
        # a batch of physics inputs (each (3, 3) or (B, 3, 3) lanes) is one
        # run of lanes
        physics = (dm_vac, U, mat_pot, lri_pot)
        lead = torch.broadcast_shapes(*(
            x.shape[:-2] if d is None else tuple(x.movedim(d, 0).shape[1:-2])
            for x, d in zip(physics, in_dims)))
        outputs = OscProbsGeneral.apply(
            *_as_lanes([(x, (3, 3)) for x in physics], in_dims[:4],
                       info.batch_size, lead), geom, nubar)
        shape = (info.batch_size,) + lead
        return tuple(x.reshape(shape + tuple(x.shape[1:]))
                     for x in outputs), (0, 0, 0)


class _OscProbsGeneralTangent(torch.autograd.Function):
    """The tangent of :class:`OscProbsGeneral`'s probabilities along one
    direction of its physics inputs (the pack's tangent, one tangent
    launch). Its vmap rule takes a batch of directions at one point
    (``torch.func.jacfwd``) as ceil(K / 6) multitangent launches, and a
    batch of points, each with its direction, as lanes of one tangent
    launch. It is a forward-mode rule and has no backward."""

    @staticmethod
    def forward(dm_vac, U, mat_pot, lri_pot, p2, pvec, ddm_vac, dU, dmat_pot,
                dlri_pot, geom, nubar):
        dpvec = pack_tangents((dm_vac, U, mat_pot, lri_pot),
                              (ddm_vac, dU, dmat_pot, dlri_pot), nubar)
        return _general_tangents(p2, pvec, dpvec.unsqueeze(-2),
                                 geom).squeeze(-4)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, dm_vac, U, mat_pot, lri_pot, p2, pvec, ddm_vac,
             dU, dmat_pot, dlri_pot, geom, nubar):
        physics = (dm_vac, U, mat_pot, lri_pot)
        tangents = (ddm_vac, dU, dmat_pot, dlri_pot)
        size = info.batch_size
        if all(d is None for d in in_dims[:6]):
            # K directions at one point: the directions' axis goes before
            # each matrix's, and the pack's tangents are (..., K, 57)
            dirs = tuple(
                None if t is None
                else t.unsqueeze(-3) if d is None else t.movedim(d, -3)
                for t, d in zip(tangents, in_dims[6:10]))
            dpvecs = pack_tangents(tuple(x.unsqueeze(-3) for x in physics),
                                   dirs, nubar)
            lead = tuple(pvec.shape[:-1])
            dpvecs = dpvecs.expand(lead + (size, N_PACK))
            out = _general_tangents(p2, pvec, dpvecs, geom)
            return out, len(lead)
        # a batch of points, each with its direction: lanes of one launch
        # (merged with the lanes the points carry already, if any)
        pv_dim = in_dims[5]
        lead = tuple(pvec.shape[:-1] if pv_dim is None
                     else pvec.movedim(pv_dim, 0).shape[1:-1])
        n = p2.shape[-1]
        lanes = _as_lanes(
            [(x, (3, 3)) for x in physics] + [(p2, (2, 3, n)), (pvec, (N_PACK,))]
            + [(t, (3, 3)) for t in tangents], in_dims[:10], size, lead)
        out = _OscProbsGeneralTangent.forward(*lanes, geom, nubar)
        return out.reshape((size,) + lead + tuple(out.shape[1:])), 0


def osc_probs_general(dm_vac, mix, mat_pot, lri_pot, nubar, geom):
    """General-pack propagation over ``prepare_chain_geometry(...,
    general=True)`` output (the counterpart of ``osc_probs_layers_pallas``
    :1468 with its custom VJP): (N, 3, 3) probabilities in the original
    point order, differentiable in the physics inputs.

    dm_vac real (3, 3), mix complex (3, 3) (the PMNS matrix, conjugated
    here for nubar), mat_pot complex (3, 3), lri_pot real (3, 3); float64
    (complex128) tensors on the geometry's device. Each may carry a leading
    lane axis, (B, 3, 3), which gives (B, N, 3, 3) from the launches of one
    point. Differentiable in reverse and forward mode
    (``torch.func.jacfwd``), and ``torch.func.vmap`` runs a batch as
    lanes."""
    if "slot_index" not in geom:
        raise ValueError("the general-pack route takes a geometry prepared"
                         " with prepare_chain_geometry(..., general=True)")
    U = mix if nubar > 0 else _conj(mix)
    return OscProbsGeneral.apply(dm_vac, U, mat_pot, lri_pot, geom,
                                 int(nubar))[0]
