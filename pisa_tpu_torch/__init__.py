"""
pisa_tpu_torch — the PyTorch/CUDA port of ``pisa_tpu``.

The package mirrors ``pisa_tpu``'s module paths and names, so each module's
counterpart is found under the same path. It imports ``torch`` and never
``jax``; the numpy-only host modules are copies (each names its source), and
resources are read in place from ``pisa_tpu/resources``.

Global runtime configuration (cf. ``pisa_tpu/__init__.py:48-69``):

- ``FTYPE``/``CTYPE``/``ITYPE``: numpy float/complex/int dtypes selected once
  at import from the ``PISA_TPU_FTYPE`` env var (``fp32`` default, ``fp64``),
  the same variable the JAX package reads; ``TORCH_FTYPE`` is the matching
  torch dtype used for tensors on the device.
- ``HASH_SIGFIGS``/``EPSILON``: hashing and comparison precision.
- ``ureg``/``Q_``: unit registry.
- ``PISA_TPU_NUM_DEVICES``: the number of ranks a sharded evaluation's
  default mesh spans (``parallel.default_mesh``; 0, the default: all of the
  process group), from the env var of that name
  (``pisa_tpu/__init__.py:96-98``).
- ``CACHE_DIR``: the on-disk cache location, from ``PISA_TPU_CACHE_DIR``
  (default ``$XDG_CACHE_HOME/pisa_tpu``, ``~/.cache/pisa_tpu``), as in
  ``pisa_tpu/__init__.py:100-106``.

Devices are explicit: pipelines take ``device="cuda"`` (the default) or
``device="cpu"``, and nothing falls back to the CPU when no card is found.
"""

import os

import numpy as np
import torch

__all__ = [
    "__version__",
    "FTYPE",
    "CTYPE",
    "ITYPE",
    "TORCH_FTYPE",
    "FTYPE_NAME",
    "HASH_SIGFIGS",
    "EPSILON",
    "ureg",
    "Q_",
    "PISA_TPU_NUM_DEVICES",
    "CACHE_DIR",
]

__version__ = "0.1.0"

_ftype_env = os.environ.get("PISA_TPU_FTYPE", "fp32").strip().lower()
if _ftype_env in ("fp64", "float64", "double", "64"):
    FTYPE_NAME = "fp64"
    FTYPE = np.float64
    CTYPE = np.complex128
    ITYPE = np.int64
    TORCH_FTYPE = torch.float64
    HASH_SIGFIGS = 12
elif _ftype_env in ("fp32", "float32", "single", "32"):
    FTYPE_NAME = "fp32"
    FTYPE = np.float32
    CTYPE = np.complex64
    ITYPE = np.int32
    TORCH_FTYPE = torch.float32
    HASH_SIGFIGS = 5
else:
    raise ValueError(
        f"Invalid PISA_TPU_FTYPE={_ftype_env!r}; expected 'fp32' or 'fp64'"
    )

EPSILON = 10 ** -HASH_SIGFIGS

PISA_TPU_NUM_DEVICES = int(os.environ.get("PISA_TPU_NUM_DEVICES", "0"))

CACHE_DIR = os.environ.get(
    "PISA_TPU_CACHE_DIR",
    os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "pisa_tpu",
    ),
)

from pisa_tpu_torch.units import ureg, Quantity as Q_  # noqa: E402
