"""
The generalized likelihood's host C route in the port
(``pisa_tpu_torch/utils/llh_defs/native.py``, ``use_c=True``) against the
JAX package's (``pisa_tpu/utils/llh_defs/native.py``) and against the
port's torch recursion, in fp64 on the CPU.

Tolerances: the port's C library against the JAX package's 1e-14 relative
(the same source, compiled by the same compiler with the same flags); the C
route against the torch recursion 1e-10 relative and 1e-12 absolute (the
reference test's, ``tests/test_generalized_llh.py``: two summation
orders of the same recursion).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from pisa_tpu.utils import stats as jax_stats
from pisa_tpu.utils.llh_defs import native as jax_native
from pisa_tpu_torch.utils import stats
from pisa_tpu_torch.utils.llh_defs import native
from pisa_tpu_torch.utils.llh_defs.poisson import generalized_pg_log_mixture

SAME_SOURCE_RTOL = 1e-14
RECURSION_RTOL, RECURSION_ATOL = 1e-10, 1e-12


def _mixture_inputs():
    """The reference test's inputs: 40 bins of 3 sources, one source with
    a NaN alpha and one with a zero beta (both masked)."""
    rng = np.random.RandomState(4)
    B, S = 40, 3
    k = rng.randint(0, 30, B)
    alphas = rng.uniform(0.5, 20.0, (B, S))
    betas = rng.uniform(0.2, 5.0, (B, S))
    alphas[3, 1] = np.nan
    betas[7, 2] = 0.0
    return k, alphas, betas


def test_c_source_is_the_jax_packages():
    ref = os.path.join(os.path.dirname(jax_native.__file__),
                       "poisson_gamma.c")
    assert filecmp.cmp(native.SOURCE, ref, shallow=False)


def test_c_route_matches_jax_c_and_torch_recursion():
    k, alphas, betas = _mixture_inputs()
    got = native.pg_log_mixture_c(k, alphas, betas)
    want = jax_native.pg_log_mixture_c(k, alphas, betas)
    np.testing.assert_allclose(got, want, rtol=SAME_SOURCE_RTOL, atol=0)
    torch_route = generalized_pg_log_mixture(
        torch.as_tensor(k), torch.as_tensor(alphas), torch.as_tensor(betas),
        k_max=int(k.max())).numpy()
    np.testing.assert_allclose(got, torch_route, rtol=RECURSION_RTOL,
                               atol=RECURSION_ATOL)


@pytest.mark.parametrize("n_mc", [50.0, "mixed"])
def test_use_c_through_stats_matches_torch_route(n_mc):
    """Through ``stats.generalized_poisson_llh``: low statistics in every
    bin, or every branch (empty bins, high-statistics bins, the mixture)."""
    rng = np.random.RandomState(5)
    B, S = 12, 2
    expected = {
        "weights": rng.uniform(1, 5, (S, B)),
        "llh_alphas": rng.uniform(1, 10, (S, B)),
        "llh_betas": rng.uniform(0.5, 2, (S, B)),
        "n_mc_events": np.full((S, B), 50.0),
    }
    if n_mc == "mixed":
        expected["n_mc_events"][:, 2] = 0.0
        expected["n_mc_events"][:, 5] = 150.0
    k = torch.as_tensor(rng.randint(0, 12, B), dtype=torch.float64)
    tensors = {key: torch.as_tensor(v) for key, v in expected.items()}
    via_c = stats.generalized_poisson_llh(k, tensors, use_c=True)
    via_torch = stats.generalized_poisson_llh(k, tensors)
    assert via_c.dtype == via_torch.dtype and via_c.device == k.device
    np.testing.assert_allclose(via_c.numpy(), via_torch.numpy(),
                               rtol=RECURSION_RTOL, atol=RECURSION_ATOL)
    np.testing.assert_allclose(
        via_c.numpy(),
        np.asarray(jax_stats.generalized_poisson_llh(k.numpy(), expected,
                                                     use_c=True)),
        rtol=RECURSION_RTOL, atol=RECURSION_ATOL)


def test_use_c_raises_without_a_compiler(tmp_path, monkeypatch):
    """No compiler: the route raises naming it, and takes no other."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    k, alphas, betas = _mixture_inputs()
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.pg_log_mixture_c(k, alphas, betas)
    expected = {"weights": torch.ones(2, 4), "llh_alphas": torch.ones(2, 4),
                "llh_betas": torch.ones(2, 4),
                "n_mc_events": torch.full((2, 4), 5.0)}
    with pytest.raises(RuntimeError, match="no C compiler"):
        stats.generalized_poisson_llh(torch.ones(4), expected, use_c=True)
