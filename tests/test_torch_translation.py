"""
The port's events <-> binned translation (``pisa_tpu_torch.core.translation``)
against the JAX package's (``pisa_tpu.core.translation``) on the same seeded
inputs: bin search conventions (exact edges, the closed last bin, under- and
overflow, NaN), flat indices, histograms (single and multi-channel,
averaged, and the one-hot matmul form), lookup and resample. fp64
(conftest); the two implement the same integer/float arithmetic, so results
agree to round-off.
"""

import numpy as np
import pytest
import torch

from pisa_tpu import ureg as jax_ureg
from pisa_tpu.core import binning as jax_binning
from pisa_tpu.core import translation as jax_translation
from pisa_tpu_torch import ureg as torch_ureg
from pisa_tpu_torch.core import binning as torch_binning
from pisa_tpu_torch.core import translation as torch_translation


def _binning(mod, ureg):
    return mod.MultiDimBinning(
        [
            mod.OneDimBinning(
                "true_energy", num_bins=7, is_log=True,
                domain=[1, 100] * ureg.GeV,
            ),
            mod.OneDimBinning("true_coszen", num_bins=5, is_lin=True,
                              domain=[-1, 1]),
        ]
    )


def _sample(n=2000, seed=1):
    """Coordinates inside and outside the binning, plus exact edges and
    NaNs."""
    rng = np.random.RandomState(seed)
    e = 10 ** rng.uniform(-0.2, 2.2, n)
    cz = rng.uniform(-1.1, 1.1, n)
    e_edges = np.logspace(0, 2, 8)
    cz_edges = np.linspace(-1, 1, 6)
    e[:8] = e_edges
    cz[:6] = cz_edges
    e[10], cz[11] = np.nan, np.nan
    return e, cz


def _both(n=2000, seed=1):
    e, cz = _sample(n, seed)
    jb = _binning(jax_binning, jax_ureg)
    tb = _binning(torch_binning, torch_ureg)
    return (e, cz), jb, tb, [torch.as_tensor(e), torch.as_tensor(cz)]


def test_find_index_conventions_match():
    (e, cz), jb, tb, _ = _both()
    for values, jdim, tdim in ((e, jb.dims[0], tb.dims[0]),
                               (cz, jb.dims[1], tb.dims[1])):
        want = np.asarray(
            jax_translation.find_index(values, jdim.edge_magnitudes)
        )
        got = torch_translation.find_index(
            torch.as_tensor(values), np.array(tdim.edge_magnitudes)
        ).numpy()
        np.testing.assert_array_equal(got, want)
    # the closed last bin, overflow and NaN
    edges = np.array([0.0, 1.0, 2.0])
    got = torch_translation.find_index(
        torch.tensor([2.0, 2.5, -0.5, np.nan, 1.0]), edges
    ).tolist()
    assert got == [1, 2, -1, 2, 1]


def test_flat_indices_match():
    (e, cz), jb, tb, sample = _both()
    want = np.asarray(jax_translation.sanitized_flat_indices([e, cz], jb))
    got = torch_translation.sanitized_flat_indices(sample, tb).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == tb.size).any() and (got < tb.size).any()


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("averaged", [False, True])
def test_histogram_matches(channels, averaged):
    (e, cz), jb, tb, sample = _both()
    rng = np.random.RandomState(2)
    shape = (e.size,) if channels == 0 else (e.size, channels)
    w = rng.uniform(0, 2, shape)
    want = np.asarray(
        jax_translation.histogram([e, cz], w, jb, averaged=averaged)
    )
    got = torch_translation.histogram(
        sample, torch.as_tensor(w), tb, averaged=averaged
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_histogram_matmul_matches_scatter():
    _, _, tb, sample = _both()
    idx = torch_translation.sanitized_flat_indices(sample, tb)
    onehot = torch.nn.functional.one_hot(idx, tb.size + 1)[:, : tb.size]
    w = torch.as_tensor(np.random.RandomState(3).uniform(0, 2, (idx.shape[0], 2)))
    np.testing.assert_allclose(
        torch_translation.histogram_matmul(w, onehot.double()).numpy(),
        torch_translation.histogram(sample, w, tb).numpy(),
        rtol=1e-12,
    )


def test_stacked_coordinates_pad_to_the_sentinel():
    """Coordinates of any shape: a stacked container's (C, n_pad) ones, NaN
    in the padded slots, give (C, n_pad) indices with the padding at the
    out-of-range sentinel `size`, row by row what the flat search gives;
    the stacked one-hot product is C histogram_matmul calls, and a padded
    event adds to no bin."""
    (e, cz), _, tb, _ = _both(n=600)
    n_cats, n_pad, sizes = 3, 250, (200, 250, 150)
    stacked = [np.full((n_cats, n_pad), np.nan) for _ in range(2)]
    for c, n in enumerate(sizes):
        stacked[0][c, :n] = e[c * 200:c * 200 + n]
        stacked[1][c, :n] = cz[c * 200:c * 200 + n]
    sample = [torch.as_tensor(x) for x in stacked]
    idx = torch_translation.sanitized_flat_indices(sample, tb)
    assert idx.shape == (n_cats, n_pad)
    w = torch.as_tensor(
        np.random.RandomState(3).uniform(0, 2, (n_cats, n_pad, 2)))
    onehot = torch.nn.functional.one_hot(idx, tb.size + 1)[..., :tb.size]
    got = torch_translation.histogram_matmul_stacked(w, onehot.double())
    got1 = torch_translation.histogram_matmul_stacked(w[..., 0],
                                                      onehot.double())
    assert got.shape == (n_cats, tb.size, 2)
    for c, n in enumerate(sizes):
        row = [x[c] for x in sample]
        np.testing.assert_array_equal(
            idx[c], torch_translation.sanitized_flat_indices(row, tb))
        assert (idx[c, n:] == tb.size).all()
        want = torch_translation.histogram(
            [x[:n] for x in row], w[c, :n], tb)
        np.testing.assert_allclose(got[c], want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got1[c], want[:, 0], rtol=1e-12, atol=0)


def test_lookup_matches():
    (e, cz), jb, tb, sample = _both()
    table = np.random.RandomState(4).uniform(0, 1, (tb.size, 2))
    want = np.asarray(jax_translation.lookup([e, cz], table, jb))
    got = torch_translation.lookup(sample, torch.as_tensor(table), tb).numpy()
    np.testing.assert_array_equal(got, want)


def test_resample_matches():
    """Binned values on a fine grid resampled onto a coarser one (averaged
    where a coarse bin holds several fine centers, looked up otherwise)."""
    def grids(mod, ureg, n):
        return mod.MultiDimBinning(
            [
                mod.OneDimBinning("true_energy", num_bins=n, is_log=True,
                                  domain=[1, 100] * ureg.GeV),
                mod.OneDimBinning("true_coszen", num_bins=n, is_lin=True,
                                  domain=[-1, 1]),
            ]
        )

    def centers(binning):
        mesh = binning.meshgrid(entity="weighted_centers", attach_units=False)
        return [np.asarray(m, dtype=np.float64).ravel() for m in mesh]

    fine_j, coarse_j = grids(jax_binning, jax_ureg, 12), grids(
        jax_binning, jax_ureg, 5)
    fine_t, coarse_t = grids(torch_binning, torch_ureg, 12), grids(
        torch_binning, torch_ureg, 5)
    values = np.random.RandomState(5).uniform(0, 1, fine_j.size)
    want = np.asarray(
        jax_translation.resample(
            values, centers(fine_j), fine_j, centers(coarse_j), coarse_j
        )
    )
    got = torch_translation.resample(
        torch.as_tensor(values),
        [torch.as_tensor(c) for c in centers(fine_t)],
        fine_t,
        [torch.as_tensor(c) for c in centers(coarse_t)],
        coarse_t,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
