"""
PMNS mixing matrix and mass-splitting matrix, as complex torch tensors.

Counterpart of ``pisa_tpu/ops/osc/pmns.py`` (reference
``pisa/stages/osc/osc_params.py``: ``mix_matrix:175``,
``mix_matrix_reparam:214``, ``dm_matrix:266``). The JAX package builds these
in split (re, im) form because the TPU has no complex dtype; here they are
plain complex tensors. ``pmns_matrix_complex`` and ``OscParams`` are the
host-side API of the reference: numpy arrays in float64 and complex128.

Conventions:
- standard 3x3 PDG parameterization U = R23(t23) . U13(t13, dcp) . R12(t12)
- reparameterized variant U' = diag(e^{i dcp},1,1) U diag(e^{-i dcp},1,1)
- dm_matrix[i,j] = m_i^2 - m_j^2 with (m1^2, m2^2, m3^2) = (0, dm21, dm31),
  degeneracies broken by +/- 5e-9 eV^2
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pmns_matrix",
    "pmns_matrix_reparam",
    "pmns_matrix_complex",
    "dm_matrix",
    "OscParams",
]

DEGENERACY_DELTA = 5.0e-9  # eV^2, cf. reference osc_params.py:270


def pmns_matrix(sin12, sin13, sin23, deltacp):
    """Standard-parameterization PMNS matrix (complex (3, 3)) from 0-d real
    tensors: sines of the mixing angles and the CPV phase (radians); (B,)
    lanes of them give (B, 3, 3)."""
    c12 = torch.sqrt(1.0 - sin12**2)
    c13 = torch.sqrt(1.0 - sin13**2)
    c23 = torch.sqrt(1.0 - sin23**2)
    s12, s13, s23 = sin12, sin13, sin23
    cd, sd = torch.cos(deltacp), torch.sin(deltacp)
    zero = torch.zeros_like(s12)
    def matrix(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    re = matrix([
        [c12 * c13, s12 * c13, s13 * cd],
        [-s12 * c23 - c12 * s23 * s13 * cd, c12 * c23 - s12 * s23 * s13 * cd,
         s23 * c13],
        [s12 * s23 - c12 * c23 * s13 * cd, -c12 * s23 - s12 * c23 * s13 * cd,
         c23 * c13],
    ])
    im = matrix([
        [zero, zero, -s13 * sd],
        [-c12 * s23 * s13 * sd, -s12 * s23 * s13 * sd, zero],
        [-c12 * c23 * s13 * sd, -s12 * c23 * s13 * sd, zero],
    ])
    return torch.complex(re, im)


def pmns_matrix_reparam(sin12, sin13, sin23, deltacp):
    """Reparameterized PMNS matrix diag(e^{i dcp},1,1) U diag(e^{-i dcp},1,1)
    (cf. reference ``osc_params.py:214``)."""
    u = pmns_matrix(sin12, sin13, sin23, deltacp)
    one = torch.ones_like(deltacp)
    phase = torch.polar(one, deltacp)
    left = torch.stack([phase, one.to(phase.dtype), one.to(phase.dtype)],
                       dim=-1)
    return left[..., :, None] * u * left.conj()[..., None, :]


def dm_matrix(dm21, dm31):
    """Antisymmetric vacuum mass-splitting matrix dm[i,j] = m_i^2 - m_j^2
    with degeneracy-breaking (cf. reference ``osc_params.py:266``); 0-d real
    tensors in, real (3, 3) out; (B,) lanes give (B, 3, 3)."""
    zero = torch.zeros_like(dm21)
    m0 = torch.where(dm21 == 0.0, zero - DEGENERACY_DELTA, zero)
    m2 = torch.where(dm31 == 0.0, zero + DEGENERACY_DELTA, dm31)
    m = torch.stack([m0, dm21, m2], dim=-1)
    return m[..., :, None] - m[..., None, :]


def _host(*values):
    return [torch.as_tensor(v, dtype=torch.float64) for v in values]


def pmns_matrix_complex(sin12, sin13, sin23, deltacp, reparam=False):
    """Host-side numpy complex128 PMNS matrix (reparameterized if
    `reparam`) from floats."""
    fn = pmns_matrix_reparam if reparam else pmns_matrix
    return fn(*_host(sin12, sin13, sin23, deltacp)).numpy()


class OscParams:
    """Host-side oscillation-parameter container mirroring the reference
    ``OscParams`` API (angles set via theta or sin properties; matrices
    exposed as numpy arrays, real and imaginary parts of a mixing matrix
    stacked on its last axis)."""

    def __init__(self):
        self.sin12 = 0.0
        self.sin13 = 0.0
        self.sin23 = 0.0
        self.deltacp = 0.0
        self.dm21 = 0.0
        self.dm31 = 0.0

    @property
    def theta12(self):
        return np.arcsin(self.sin12)

    @theta12.setter
    def theta12(self, value):
        self.sin12 = np.sin(value)

    @property
    def theta13(self):
        return np.arcsin(self.sin13)

    @theta13.setter
    def theta13(self, value):
        self.sin13 = np.sin(value)

    @property
    def theta23(self):
        return np.arcsin(self.sin23)

    @theta23.setter
    def theta23(self, value):
        self.sin23 = np.sin(value)

    @property
    def mix_matrix_complex(self):
        return pmns_matrix_complex(
            self.sin12, self.sin13, self.sin23, self.deltacp
        )

    @property
    def mix_matrix(self):
        m = self.mix_matrix_complex
        return np.stack([m.real, m.imag], axis=-1)

    @property
    def mix_matrix_reparam_complex(self):
        return pmns_matrix_complex(
            self.sin12, self.sin13, self.sin23, self.deltacp, reparam=True
        )

    @property
    def mix_matrix_reparam(self):
        m = self.mix_matrix_reparam_complex
        return np.stack([m.real, m.imag], axis=-1)

    @property
    def dm_matrix(self):
        return dm_matrix(*_host(self.dm21, self.dm31)).numpy()
