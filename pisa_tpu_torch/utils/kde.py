"""
KDE-smoothed histograms (counterpart of ``pisa_tpu/utils/kde.py``;
reference ``pisa/utils/kde_hist.py:35,220``).

The adaptive weighted Gaussian KDE of the JAX package, with the same
statistics: a diagonal bandwidth from the weighted standard deviation and
the effective sample size (Scott or Silverman), Abramson local widths
``lambda_i = (pilot_i / g)^(-alpha)`` from a fixed-width pilot at the
samples (g its weighted geometric mean). The weighted statistics are torch
ops; the two Gaussian sums (the pilot, and the density at the evaluation
points) and their gradients are the CUDA kernel pair of ``ops/kde.py``
inside one ``torch.autograd.Function`` (``ops/kde.py:AdaptiveDensity``),
so no (samples x points) intermediate is ever stored.

Everything here takes a leading batch axis: ``x`` (B, D, N) and weights
(B, N) evaluate B independent densities in one launch per pass. PID
channels are selected by weight zeroing, exactly as in the JAX package, so
shapes stay static and the stacked KDE stage is one batch of (categories x
channels).

The histogram conveniences follow the JAX package: coszen reflection at the
+-1 edges, evaluation at the (oversampled) bin centres, bin volumes, the
oversample reduction, per-PID stacking and bootstrap errors by multinomial
resampling with ``np.random.default_rng(seed)`` (so the port reproduces the
JAX package's numbers). What depends on the binning alone is built on the
host once (:func:`_prepare_static`): the evaluation grid and one index map
that takes every grid point (and PID channel) to its output bin with its
bin volume, which folds the reflection, the volume, the oversample
reduction and the axis order into one ``index_add`` on the device
(:class:`KDEPlan`). Nothing in an evaluation reads a tensor on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.container import resolve_device
from pisa_tpu_torch.ops.kde import adaptive_density

__all__ = [
    "adaptive_gaussian_kde",
    "kde_bandwidths",
    "get_hist",
    "kde_histogramdd",
    "KDEPlan",
    "traced",
]


def kde_bandwidths(x, weights, bw_method="scott"):
    """The weighted statistics of ``adaptive_gaussian_kde`` (torch ops,
    differentiable in `weights`): (x with the coordinates of zero-weight
    samples made finite, the normalized weights (zeros where the total is
    not positive), the bandwidths h (..., D) clamped to 1e-30). x is
    (..., D, N), weights (..., N)."""
    d = x.shape[-2]
    sum_w = weights.sum(-1, keepdim=True)
    pos = sum_w > 0
    w = torch.where(pos, weights / torch.where(pos, sum_w, 1.0), 0.0)
    tiny = torch.finfo(w.dtype).tiny
    n_eff = 1.0 / torch.clamp(torch.square(w).sum(-1), min=tiny)
    # a NaN coordinate on a zero-weight sample would poison every point
    # through 0 * NaN terms (the stacked layout's padding slots)
    x = torch.where((w > 0).unsqueeze(-2), x, torch.nan_to_num(x))
    mean = (w.unsqueeze(-2) * x).sum(-1)
    var = (w.unsqueeze(-2) * torch.square(x - mean.unsqueeze(-1))).sum(-1)
    # the JAX package's sqrt; its derivative at var = 0 would be 0 * inf
    sigma = torch.where(var > 0, torch.sqrt(torch.where(var > 0, var, 1.0)),
                        0.0)
    if bw_method == "scott":
        factor = n_eff ** (-1.0 / (d + 4))
    elif bw_method == "silverman":
        factor = (n_eff * (d + 2.0) / 4.0) ** (-1.0 / (d + 4))
    else:
        raise ValueError(f"unknown bw_method {bw_method!r}")
    h = torch.clamp(sigma * factor.unsqueeze(-1), min=1e-30)
    return x, w, h


def adaptive_gaussian_kde(x, weights, points, bw_method="scott",
                          adaptive=True, alpha=0.3):
    """Weighted (adaptive) Gaussian KDE evaluated at `points`
    (``pisa_tpu/utils/kde.py:adaptive_gaussian_kde``).

    Parameters
    ----------
    x : (D, N) or (B, D, N) tensor, the samples
    weights : (N,) or (B, N) tensor (need not be normalized)
    points : (D, G) or (B, D, G) tensor, the evaluation points
    bw_method : 'scott' or 'silverman'
    adaptive : bool, Abramson local bandwidths
    alpha : float, adaptivity exponent

    Returns the density (G,) or (B, G), normalized to integrate to 1 (zeros
    for a batch entry without weight), differentiable in `weights`.
    """
    single = x.dim() == 2
    if single:
        x, weights = x.unsqueeze(0), weights.unsqueeze(0)
        if points.dim() == 3:
            raise ValueError("batched points need batched samples")
    points = points.to(dtype=x.dtype)
    x, w, h = kde_bandwidths(x, weights, bw_method)
    dens = adaptive_density(x.contiguous(), w, h, points, bool(adaptive),
                            float(alpha))
    return dens[0] if single else dens


def _fold_maps(binning, static):
    """The index map of one prepared binning: for every evaluation point g
    (in the order of ``static["points"]``) the flat index of its bin in the
    original binning's order and the bin volume it is scaled by, found by
    running the JAX package's fold (reflection, volume, oversample
    reduction, axis order) on the identity in float64."""
    G = static["points"].shape[1]
    h = np.eye(G).reshape(static["ext_shape"] + (G,))
    l = static["n_refl"]
    os_shape = static["os_shape"]
    if static["reflect_lower"] or static["reflect_upper"]:
        pad = np.zeros((os_shape[0] - l,) + os_shape[1:] + (G,))
        h0 = h1 = None
        if static["reflect_lower"]:
            h0 = np.flip(np.concatenate([pad, h[:l]], axis=0), axis=0)
            h = h[l:]
        if static["reflect_upper"]:
            h1 = np.flip(np.concatenate([h[-l:], pad], axis=0), axis=0)
            h = h[:-l]
        if h0 is not None:
            h = h + h0
        if h1 is not None:
            h = h + h1
    h = h * static["volume"][..., None]
    ov = static["oversample"]
    if ov != 1:
        for axis in range(h.ndim - 1):
            shape = h.shape
            n_out = shape[axis] // ov
            h = h.reshape(shape[:axis] + (n_out, ov) + shape[axis + 1:]).sum(
                axis=axis + 1)
    if static["cz_bin"] != 0:
        h = np.moveaxis(h, 0, static["cz_bin"])
    T = h.reshape(-1, G)  # (bins, points)
    if np.any(np.count_nonzero(T, axis=0) > 1):
        raise RuntimeError("a KDE evaluation point lands in two bins")
    index = np.argmax(np.abs(T), axis=0)
    return index, T[index, np.arange(G)]


def _prepare_static(binning, coszen_name, coszen_reflection, oversample):
    """Host-side precomputation from the binning alone
    (``pisa_tpu/utils/kde.py:_prepare_static``): the evaluation grid, the
    coszen-reflection geometry, the oversampled shape, the bin volumes and
    the move-coszen-first order, plus the index map of :func:`_fold_maps`
    (``index``, ``factor``)."""
    out_shape = tuple(binning.shape)
    binning = binning.oversample(oversample)
    names = list(binning.names)
    if coszen_name not in names:
        raise ValueError(f"binning must contain {coszen_name!r}")
    cz_bin = names.index(coszen_name)
    if cz_bin != 0:
        order = [cz_bin] + [i for i in range(len(names)) if i != cz_bin]
        binning = MultiDimBinning([binning[names[i]] for i in order])
    else:
        order = list(range(len(names)))

    cz_dim = binning[coszen_name]
    n_refl = int(cz_dim.num_bins * float(coszen_reflection))
    reflect_lower = (
        float(cz_dim.bin_edges[0].magnitude) == -1.0 and n_refl > 0
    )
    reflect_upper = (
        float(cz_dim.bin_edges[-1].magnitude) == 1.0 and n_refl > 0
    )

    bin_points = []
    l = 0
    for b in binning:
        c = np.asarray(b.weighted_centers.magnitude)
        if b.name == coszen_name:
            l = int(len(c) * float(coszen_reflection))
            c0 = 2 * c[0] - c[1: l + 1][::-1] if reflect_lower else []
            c1 = 2 * c[-1] - c[-l - 1: -1][::-1] if reflect_upper else []
            c = np.concatenate([c0, c, c1])
        bin_points.append(c)

    ext_shape = (
        binning.shape[0] + (int(reflect_lower) + int(reflect_upper)) * l,
    ) + tuple(binning.shape[1:])
    grid = np.meshgrid(*bin_points, indexing="ij")
    points = np.stack([g.ravel() for g in grid])  # (D, G)

    static = {
        "order": order,
        "cz_bin": cz_bin,
        "points": points,
        "ext_shape": ext_shape,
        "os_shape": tuple(binning.shape),
        "n_refl": l,
        "reflect_lower": reflect_lower,
        "reflect_upper": reflect_upper,
        "volume": binning.bin_volumes(attach_units=False),
        "oversample": int(oversample),
        "out_shape": out_shape,
    }
    static["index"], static["factor"] = _fold_maps(binning, static)
    return static


class KDEPlan:
    """A prepared KDE histogram of one binning on one device: the
    evaluation points and the index map on the device, so that
    :meth:`__call__` is the weighted statistics, one batch of densities and
    one ``index_add``.

    Parameters
    ----------
    binning : MultiDimBinning, the histogram's binning (the sample's columns
        follow its dimensions)
    stack_pid : bool, a 'pid' dimension splits the sample into channels,
        each KDE'd in the other dimensions (``kde_histogramdd``)
    device : torch.device or str
    dtype : torch dtype of the points and the map
    """

    def __init__(self, binning, coszen_name="coszen", coszen_reflection=0.25,
                 oversample=1, stack_pid=True, device="cuda",
                 dtype=torch.float64):
        self.binning = binning
        self.device = resolve_device(device)
        self.dtype = dtype
        names = list(binning.names)
        self.stack_pid = bool(stack_pid)
        if self.stack_pid:
            self.pid_bin = names.index("pid")
            self.pid_edges = np.asarray(
                binning[names[self.pid_bin]].bin_edges.magnitude)
            self.other = [i for i in range(len(names)) if i != self.pid_bin]
            kde_binning = MultiDimBinning([binning[names[i]]
                                           for i in self.other])
        else:
            self.pid_bin, self.pid_edges = None, None
            self.other = list(range(len(names)))
            kde_binning = binning
        self.kde_binning = kde_binning
        self.static = _prepare_static(kde_binning, coszen_name,
                                      coszen_reflection, oversample)
        n_chan = 1 if not self.stack_pid else len(self.pid_edges) - 1
        self.n_channels = n_chan
        size = int(np.prod(binning.shape))
        # channel k's bins in the full binning: the kde binning's flat index
        # with the pid index k inserted at pid_bin
        index = []
        for k in range(n_chan):
            if not self.stack_pid:
                index.append(self.static["index"])
                continue
            multi = list(np.unravel_index(self.static["index"],
                                          kde_binning.shape))
            multi.insert(self.pid_bin, np.full_like(multi[0], k))
            index.append(np.ravel_multi_index(multi, binning.shape))
        self.size = size
        self.index = torch.as_tensor(np.concatenate(index), dtype=torch.int64,
                                     device=self.device)
        self.factor = torch.as_tensor(
            np.tile(self.static["factor"], n_chan), dtype=dtype,
            device=self.device)
        # the sample's columns for the KDE: the non-pid ones, coszen first
        self.columns = torch.as_tensor(
            [self.other[i] for i in self.static["order"]], dtype=torch.int64,
            device=self.device)
        self.points = torch.as_tensor(self.static["points"], dtype=dtype,
                                      device=self.device)
        if self.stack_pid:
            self._pid_lo, self._pid_hi = (
                torch.tensor(e, dtype=dtype, device=self.device)
                for e in (self.pid_edges[:-1], self.pid_edges[1:]))

    def channel_weights(self, sample, weights):
        """(..., K, N): the weights of each PID channel, by weight zeroing
        (``pisa_tpu/utils/kde.py:395``); K = 1 without ``stack_pid``."""
        if not self.stack_pid:
            return weights.unsqueeze(-2)
        pid = sample[..., self.pid_bin].unsqueeze(-2)  # (..., 1, N)
        mask = (pid >= self._pid_lo[:, None]) & (pid < self._pid_hi[:, None])
        return weights.unsqueeze(-2) * mask.to(weights.dtype)

    def __call__(self, sample, weights, bw_method="scott", adaptive=True,
                 alpha=0.3, total=None):
        """Histograms (..., size) in the binning's flat order of `sample`
        (..., N, D) with `weights` (..., N); the leading axes are a batch
        (categories, lanes) that broadcasts between the two. Each channel is
        scaled to its weight total, or to `total` (..., K) where given (the
        bootstrap scales every replicate to the original total)."""
        w = torch.nan_to_num(weights)
        wk = self.channel_weights(sample, w)  # (..., K, N)
        lead = tuple(wk.shape[:-2])
        K, N = wk.shape[-2:]
        x = sample.index_select(-1, self.columns).transpose(-1, -2)
        x = x.unsqueeze(-3).expand(lead + (K,) + tuple(x.shape[-2:]))
        norm = wk.sum(-1) if total is None else total
        dens = adaptive_gaussian_kde(
            x.reshape((-1,) + tuple(x.shape[-2:])), wk.reshape(-1, N),
            self.points, bw_method=bw_method, adaptive=adaptive, alpha=alpha)
        dens = dens.reshape(lead + (K, -1)) * norm.unsqueeze(-1)
        contrib = dens.reshape(lead + (-1,)) * self.factor
        out = torch.zeros(lead + (self.size,), dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(-1, self.index, contrib)


def traced(*values):
    """Whether a capture is in progress or a value carries a gradient: the
    port's counterpart of the JAX package's ``isinstance(x, Tracer)``."""
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    return capturing or any(isinstance(v, torch.Tensor) and v.requires_grad
                            for v in values)


def _as_tensor(values, device, dtype):
    if isinstance(values, torch.Tensor):
        return values
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)


def get_hist(sample, binning, weights=None, bw_method="scott", adaptive=True,
             alpha=0.3, use_cuda=False, coszen_reflection=0.25,
             coszen_name="coszen", oversample=1, bootstrap=False,
             bootstrap_niter=10, bootstrap_seed=None, device="cuda"):
    """KDE histogram with coszen-edge reflection
    (``pisa_tpu/utils/kde.py:get_hist``; reference ``kde_hist.py:35``).

    sample : (N, D) array or tensor ordered like `binning`. Returns an array
    of ``binning.shape`` scaled to sum(weights): a tensor where `sample` is
    one (on its device, differentiable in `weights`), else a numpy array
    computed on `device`. With `bootstrap`, (mean, std) of
    `bootstrap_niter` multinomial resamplings drawn with
    ``np.random.default_rng(bootstrap_seed)`` (numpy arrays). `use_cuda` is
    accepted for the reference's signature and ignored."""
    del use_cuda
    return _kde_hist(sample, binning, weights, False, bw_method, adaptive,
                     alpha, coszen_reflection, coszen_name, oversample,
                     bootstrap, bootstrap_niter, bootstrap_seed, device)


def kde_histogramdd(sample, binning, weights=None, bw_method="scott",
                    adaptive=True, alpha=0.3, use_cuda=False,
                    coszen_reflection=0.25, coszen_name="coszen",
                    oversample=1, stack_pid=True, bootstrap=False,
                    bootstrap_niter=10, bootstrap_seed=None, device="cuda"):
    """N-dim KDE histogram; with `stack_pid` the 'pid' dimension is a set of
    channels, each KDE'd in the other dimensions
    (``pisa_tpu/utils/kde.py:kde_histogramdd``; reference
    ``kde_hist.py:220``). Arguments and returns as :func:`get_hist`. The
    bootstrap resamples each channel's own events, as the JAX package does
    (on the host)."""
    del use_cuda
    return _kde_hist(sample, binning, weights, stack_pid, bw_method,
                     adaptive, alpha, coszen_reflection, coszen_name,
                     oversample, bootstrap, bootstrap_niter, bootstrap_seed,
                     device)


def _kde_hist(sample, binning, weights, stack_pid, bw_method, adaptive,
              alpha, coszen_reflection, coszen_name, oversample, bootstrap,
              bootstrap_niter, bootstrap_seed, device):
    if bootstrap and oversample > 1:
        raise ValueError("Bootstrapping cannot be combined with oversampling.")
    is_tensor = isinstance(sample, torch.Tensor)
    if is_tensor:
        device, dtype = sample.device, sample.dtype
    else:
        device, dtype = resolve_device(device), torch.float64
        sample = np.asarray(sample, dtype=np.float64)
    n_evts = sample.shape[0]
    if sample.shape[1] != len(binning.names):
        raise ValueError("sample dims != binning dims")
    if weights is not None and not isinstance(weights, torch.Tensor) and \
            len(np.atleast_1d(weights)) == 0:
        weights = None
    if weights is not None and weights.shape[0] != n_evts:
        raise ValueError("length of sample and weights incompatible")
    plan_kw = dict(coszen_name=coszen_name,
                   coszen_reflection=coszen_reflection,
                   oversample=oversample, device=device, dtype=dtype)
    kw = dict(bw_method=bw_method, adaptive=adaptive, alpha=alpha)
    if bootstrap:
        # the JAX package's bootstrap cannot run on traced values either
        # (pisa_tpu/utils/kde.py:279): its draws and statistics are the host's
        if traced(sample, weights):
            raise TypeError(
                "kde bootstrap runs on the host: not inside a CUDA-graph"
                " capture, nor on tensors that require a gradient")
        return _bootstrap(np.asarray(sample.detach().cpu() if is_tensor
                                     else sample, dtype=np.float64),
                          binning, weights, stack_pid, plan_kw, kw,
                          bootstrap_niter, bootstrap_seed)
    plan = KDEPlan(binning, stack_pid=stack_pid, **plan_kw)
    s = _as_tensor(sample, device, dtype)
    w = torch.ones(n_evts, dtype=dtype, device=device) if weights is None \
        else _as_tensor(weights, device, dtype)
    hist = plan(s, w.to(dtype), **kw).reshape(binning.shape)
    return hist if is_tensor else hist.detach().cpu().numpy()


def _bootstrap(sample, binning, weights, stack_pid, plan_kw, kw, niter,
               seed):
    """(mean, std) of `niter` resampled histograms, on the host's random
    draws (``pisa_tpu/utils/kde.py:299-310``); with `stack_pid`, each
    channel's events are resampled on their own, channel after channel, as
    the JAX package's loop does."""
    w_all = None if weights is None else np.nan_to_num(
        np.asarray(weights.detach().cpu() if isinstance(weights, torch.Tensor)
                   else weights, dtype=np.float64))
    if not stack_pid:
        return _bootstrap_one(sample, binning, w_all, plan_kw, kw, niter,
                              seed)
    names = list(binning.names)
    pid_bin = names.index("pid")
    edges = np.asarray(binning[names[pid_bin]].bin_edges.magnitude)
    other = [i for i in range(len(names)) if i != pid_bin]
    other_binning = MultiDimBinning([binning[names[i]] for i in other])
    means, stds = [], []
    for k in range(len(edges) - 1):
        mask = (sample[:, pid_bin] >= edges[k]) & (
            sample[:, pid_bin] < edges[k + 1])
        sub = sample[mask][:, other]
        w = None if w_all is None else w_all[mask]
        m, s = _bootstrap_one(sub, other_binning, w, plan_kw, kw, niter, seed)
        means.append(m)
        stds.append(s)
    return (np.moveaxis(np.stack(means), 0, pid_bin),
            np.moveaxis(np.stack(stds), 0, pid_bin))


def _bootstrap_one(sample, binning, w_host, plan_kw, kw, niter, seed):
    n = sample.shape[0]
    if w_host is None:
        w_host = np.ones(n)
    plan = KDEPlan(binning, stack_pid=False, **plan_kw)
    rng = np.random.default_rng(seed)
    counts = np.stack([np.bincount(rng.integers(n, size=n), minlength=n)
                       for _ in range(niter)])
    device, dtype = plan.device, plan.dtype
    s = torch.as_tensor(sample, dtype=dtype, device=device)
    w = torch.as_tensor(w_host * counts, dtype=dtype, device=device)
    total = torch.full((niter, 1), float(w_host.sum()), dtype=dtype,
                       device=device)
    hists = plan(s, w, total=total, **kw).reshape(
        (niter,) + tuple(binning.shape)).cpu().numpy()
    return hists.mean(axis=0), hists.std(axis=0)
