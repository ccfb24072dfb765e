"""
ctypes binding of the host C Poisson-gamma mixture library, the route of
``generalized_poisson_llh(use_c=True)`` (counterpart of
``pisa_tpu/utils/llh_defs/native.py``; reference
``pisa/utils/llh_defs/poisson_gamma.c``, built by its ``setup.py``).

The source is the port's own copy, ``pisa_tpu_torch/csrc/poisson_gamma.c``,
byte for byte the JAX package's (a test holds the two equal). It is
compiled at first use with ``$CC`` (default ``cc``) into the port's build
directory (``utils/cuda_build.py:BUILD_DIR``), keyed by a hash of the
source, and loaded with ctypes. Where no compiler or library can be had,
:func:`pg_log_mixture_c` raises with the compiler's error: the caller asked
for this route, and nothing falls back to the torch recursion.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from pisa_tpu_torch.utils.cuda_build import BUILD_DIR

__all__ = ["SOURCE", "available", "library", "pg_log_mixture_c"]

#: the port's copy of the C source
SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "csrc", "poisson_gamma.c")

_LIB = None
_DOUBLES = ctypes.POINTER(ctypes.c_double)
_LONGS = ctypes.POINTER(ctypes.c_long)


def _build():
    """The library's path, compiled from :data:`SOURCE` unless a build of
    the same source is there."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libpoisson_gamma-{digest}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "libpoisson_gamma.so")
        cmd = [cc, "-O2", "-shared", "-fPIC", "-o", out, SOURCE, "-lm"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"generalized_poisson_llh(use_c=True): no C compiler"
                f" ({cc!r}: {exc}); set $CC or use the torch route") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"generalized_poisson_llh(use_c=True): {' '.join(cmd)} failed"
                f" ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)
    return path


def library():
    """The loaded library, built at the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        lib.pg_log_mixture.restype = None
        lib.pg_log_mixture.argtypes = [_LONGS, _DOUBLES, _DOUBLES,
                                       ctypes.c_long, ctypes.c_long,
                                       _DOUBLES, _DOUBLES]
        _LIB = lib
    return _LIB


def available():
    """True if the library builds and loads (:func:`library` raises
    otherwise)."""
    try:
        library()
    except (OSError, RuntimeError):
        return False
    return True


def pg_log_mixture_c(k, alphas, betas):
    """log P(k) per bin from the C library, on the host in float64: k (B,)
    counts, alphas and betas (B, S). Returns a (B,) numpy array."""
    lib = library()
    k = np.ascontiguousarray(np.asarray(k, dtype=np.int64).ravel())
    alphas = np.ascontiguousarray(np.atleast_2d(alphas), dtype=np.float64)
    betas = np.ascontiguousarray(np.atleast_2d(betas), dtype=np.float64)
    if alphas.shape != betas.shape or alphas.shape[0] != k.shape[0]:
        raise ValueError(f"shape mismatch: k {k.shape}, alphas"
                         f" {alphas.shape}, betas {betas.shape}")
    n_bins, n_sources = alphas.shape
    out = np.empty(n_bins, dtype=np.float64)
    max_k = int(k.max()) if n_bins else 0
    scratch = np.empty(2 * max_k + 1 + n_sources, dtype=np.float64)
    lib.pg_log_mixture(k.ctypes.data_as(_LONGS),
                       alphas.ctypes.data_as(_DOUBLES),
                       betas.ctypes.data_as(_DOUBLES), n_bins, n_sources,
                       out.ctypes.data_as(_DOUBLES),
                       scratch.ctypes.data_as(_DOUBLES))
    return out
