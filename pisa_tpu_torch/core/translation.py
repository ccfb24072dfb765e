"""
Events <-> binned translation as torch ops.

Counterpart of ``pisa_tpu/core/translation.py`` (reference
``pisa/core/translation.py:49,90,228,504``), with the same conventions:

- ``find_index``: bin search with underflow -> -1, overflow -> num_bins, the
  last bin closed, NaN -> overflow; ``lookup_indices_flat`` the flat index
  per event, -1 or the binning's size out of range;
- ``histogram``: scatter-add (``index_add_``) over flat bin indices, with
  multi-channel weights (N, ch) and an 'averaged' mode (divide by counts);
- ``histogram_matmul``: the histogram as ``weights @ one_hot`` (the JAX
  package's MXU path), a plain ``torch.matmul``;
- ``histogram_matmul_stacked``: the same for category-stacked weights
  ``(C, N[, ch])`` against the stacked ``(C, N, size)`` one-hot, one einsum;
- ``lookup``: gather of binned values at event positions;
- ``resample``: the reference's hybrid histogram/lookup rebinning.

Out-of-range events land in a dropped overflow bucket at ``size``. The
coordinate tensors may have any shape: a stacked container's ``(C, n_pad)``
coordinates, NaN in the padded slots, give ``(C, n_pad)`` indices with the
padding at the out-of-range sentinel ``size``.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.core.binning import MultiDimBinning

__all__ = [
    "binning_to_spec",
    "find_index",
    "sanitized_flat_indices",
    "lookup_indices_flat",
    "histogram",
    "histogram_matmul",
    "histogram_matmul_stacked",
    "lookup",
    "resample",
]


def binning_to_spec(binning: MultiDimBinning):
    """Per-dimension dicts of float64 edge magnitudes and bin counts."""
    return tuple(
        dict(
            edges=np.array(dim.edge_magnitudes, dtype=np.float64),
            num_bins=dim.num_bins,
        )
        for dim in binning.dims
    )


def _as_spec(binning_or_spec):
    if isinstance(binning_or_spec, MultiDimBinning):
        return binning_to_spec(binning_or_spec)
    return binning_or_spec


def _size(spec):
    return int(np.prod([d["num_bins"] for d in spec]))


def find_index(vals, edges):
    """Bin index per value (reference ``translation.py:504``): -1 underflow,
    ``num_bins`` overflow, last bin closed, NaN -> overflow. Edges are cast
    to the values' dtype, as in the JAX package."""
    edges = torch.as_tensor(edges, dtype=vals.dtype, device=vals.device)
    n = edges.shape[0] - 1
    idx = torch.searchsorted(edges, vals.contiguous(), right=True) - 1
    idx = torch.where(vals == edges[-1], n - 1, idx)
    idx = torch.where(torch.isnan(vals), n, idx)
    return idx


def _flat_indices(sample, spec):
    """Row-major flat bin index per event plus the any-dim under/overflow
    masks; `sample` holds one coordinate tensor per dimension."""
    if len(sample) != len(spec):
        raise ValueError(f"{len(sample)} coordinates for {len(spec)} dims")
    flat = under = over = None
    for coords, dim in zip(sample, spec):
        idx = find_index(coords, dim["edges"])
        n = dim["num_bins"]
        u, o = idx < 0, idx >= n
        under = u if under is None else under | u
        over = o if over is None else over | o
        idx = idx.clamp(0, n - 1)
        flat = idx if flat is None else flat * n + idx
    return flat, under, over


def sanitized_flat_indices(sample, binning_or_spec):
    """Row-major flat bin index per event, with any-dim under/overflow
    mapped to ``size`` (the drop bucket of :func:`histogram`/:func:`lookup`).
    Parameter-independent: callers cache it across templates."""
    spec = _as_spec(binning_or_spec)
    flat, under, over = _flat_indices(sample, spec)
    return torch.where(under | over, _size(spec), flat)


def lookup_indices_flat(sample, binning_or_spec):
    """Flat bin index per event (int32): -1 for an underflow in any
    dimension (checked first), the binning's size for an overflow
    (``pisa_tpu/core/translation.py:106``; reference
    ``bin_indexing.py:104``)."""
    spec = _as_spec(binning_or_spec)
    flat, under, over = _flat_indices(sample, spec)
    return torch.where(under, -1, torch.where(over, _size(spec), flat)).to(
        torch.int32)


def histogram(sample, weights, binning_or_spec, averaged=False, idx=None,
              laned=False):
    """Histogram `sample` into the binning, weighted by `weights` ((N,) or
    (N, ch); None for counts). With `averaged`, per-bin sums are divided by
    per-bin counts (empty bins -> 0). `idx`: precomputed
    :func:`sanitized_flat_indices`. Returns (size,) or (size, ch). With
    `laned`, `weights` and the result carry a leading lane axis (B, ...):
    one scatter-add along the bins of every lane at once."""
    spec = _as_spec(binning_or_spec)
    size = _size(spec)
    if idx is None:
        idx = sanitized_flat_indices(sample, spec)
    if weights is None:
        w = torch.ones(idx.shape[0], dtype=sample[0].dtype, device=idx.device)
    else:
        w = weights
    lead = tuple(w.shape[:1]) if laned else ()
    axis = len(lead)
    out = torch.zeros(lead + (size + 1,) + tuple(w.shape[axis + 1:]),
                      dtype=w.dtype, device=w.device)
    flat_hist = out.index_add_(axis, idx, w).narrow(axis, 0, size)
    if averaged:
        counts = torch.zeros(size + 1, dtype=w.dtype, device=w.device)
        counts = counts.index_add_(0, idx, torch.ones_like(idx, dtype=w.dtype))
        counts = counts[:size].reshape((size,) + (1,) * (w.dim() - axis - 1))
        flat_hist = torch.where(
            counts > 0, flat_hist / torch.where(counts > 0, counts, 1.0), 0.0
        )
    return flat_hist


def histogram_matmul(weights, matrix, laned=False):
    """Histogram as one dense product with the cached ``(N, size)`` one-hot
    bin-membership matrix (an all-zero row marks an out-of-range event).
    ``weights`` is (N,) or (N, ch); returns (size,) or (size, ch). With
    `laned`, a leading lane axis on both. The caller keeps TF32 off for
    float32 products (stages/utils/hist.py)."""
    if weights.dim() == (2 if laned else 1):
        return weights @ matrix
    return (weights.transpose(-1, -2) @ matrix).transpose(-1, -2)


def histogram_matmul_stacked(weights, matrix, laned=False):
    """Per-category histograms as one batched product with the stacked
    ``(C, N, size)`` one-hot matrix (all-zero rows mark padded and
    out-of-range events). ``weights`` is (C, N) or (C, N, ch); returns
    (C, size) or (C, size, ch), as C calls of :func:`histogram_matmul`.
    With `laned`, a leading lane axis on both."""
    if weights.dim() == (3 if laned else 2):
        return torch.einsum("...cn,cnb->...cb", weights, matrix)
    return torch.einsum("...cnk,cnb->...cbk", weights, matrix)


def lookup(sample, flat_hist, binning_or_spec, idx=None):
    """Binned values at event positions; out-of-range events get 0
    (reference ``translation.py:228``)."""
    spec = _as_spec(binning_or_spec)
    size = _size(spec)
    if idx is None:
        idx = sanitized_flat_indices(sample, spec)
    invalid = idx >= size
    vals = flat_hist[idx.clamp(0, flat_hist.shape[0] - 1)]
    if flat_hist.dim() > 1:
        invalid = invalid[:, None]
    return torch.where(invalid, torch.zeros((), dtype=vals.dtype,
                                            device=vals.device), vals)


def resample(weights, old_sample, old_binning, new_sample, new_binning):
    """Resample binned `weights` (given at `old_sample` points under
    `old_binning`) onto `new_binning` at `new_sample` points: averaged
    histogram where new bins receive >1 points, point lookup otherwise
    (reference ``translation.py:49``). The averages are summed in float64
    and rounded once to the weights' type: a float32 sum's rounding would
    follow the order of the card's atomic adds, which differs from call to
    call and between a laned call and its lanes one by one."""
    old_spec = _as_spec(old_binning)
    new_spec = _as_spec(new_binning)
    hist_avg = histogram(old_sample, weights.to(torch.float64), new_spec,
                         averaged=True).to(weights.dtype)
    counts = histogram(old_sample, None, new_spec)
    looked_up = lookup(new_sample, weights, old_spec)
    mask = counts > 1
    if hist_avg.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, hist_avg, looked_up)
