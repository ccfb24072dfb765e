"""
Host copy of ``pisa_tpu/utils/matrix.py``.

Matrix helpers (cf. reference ``pisa/utils/matrix.py:58``).
"""

import numpy as np

__all__ = ["fronebius_nearest_psd", "is_psd"]


def is_psd(A):
    """Is `A` positive semi-definite? (symmetrized eigvalue check)"""
    A = np.asarray(A)
    sym = 0.5 * (A + A.T)
    return bool(np.all(np.linalg.eigvalsh(sym) >= 0))


def fronebius_nearest_psd(A, return_distance=False):
    """Nearest positive semi-definite matrix in Frobenius norm (Higham 1988):
    symmetrize, then clip negative eigenvalues of the symmetric polar factor.
    """
    A = np.asarray(A, dtype=float)
    assert A.ndim == 2 and A.shape[0] == A.shape[1], "need a square matrix"
    B = 0.5 * (A + A.T)
    _, s, V = np.linalg.svd(B)
    H = V.T @ np.diag(s) @ V
    A2 = 0.5 * (B + H)
    A2 = 0.5 * (A2 + A2.T)
    # ensure strictly PSD despite rounding
    k = 0
    eye = np.eye(A.shape[0])
    while not is_psd(A2):
        k += 1
        mineig = np.min(np.real(np.linalg.eigvals(A2)))
        A2 += eye * (-mineig * k**2 + np.spacing(mineig))
    if return_distance:
        return A2, np.linalg.norm(A - A2, ord="fro")
    return A2
