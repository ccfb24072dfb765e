"""
Histogramming stage (counterpart of ``pisa_tpu/stages/utils/hist.py``;
reference ``pisa/stages/utils/hist.py:17``): converts per-event weights into
binned weights under the output binning, with sumw2 errors.

The histogram is one product of the weight channels with each container's
cached one-hot bin-membership matrix (``translation.histogram_matmul``), as
the JAX package computes it with ``Precision.HIGHEST``: TF32 is switched off
for CUDA matmuls at setup, so float32 products keep full float32 precision.
A container whose matrix would exceed the size budget is scatter-added
(with lanes, one ``index_add_`` along the bins of every lane). A
category-stacked container (``core/stacking.py``) is histogrammed in one
batched op.

Rate deferral (:meth:`hist.prepare_rate_defer`): when the oscillation stage
hands over its flux x probability rate on the calc grid instead of gathering
it to the events, the histogram is the contraction of that rate with static
(category x grid x bins) matrices S and S2, built once per template and kept
on that template's stacked container (``container.rate_defer``), never on
this stage: two templates over one pipeline each have their own.

On a sharded template (``parallel/sharding.py``) each rank histograms its
slice of the events, and the ranks' partial channels are summed with one
``all_reduce`` before anything that is not linear in them: the sumw2
errors take their square root after it. Under rate deferral each rank
contracts its rows of the calc grid with its rows of S and S2, and the
category scalars travel in the same ``all_reduce``: the rank whose slice
holds a category's reference event contributes its factor, the others 0.

In an evaluation of lanes (``container.lanes``) the weights and the rate
carry a leading lane axis B: the deferred histogram is then, per category,
one (B, grid) @ (grid, bins) product, a GEMM where one point's is a GEMV.

Options, as in the JAX package: ``apply_unc_weights`` multiplies the
weights by the events' ``unc_weights`` (the sumw2 errors' third channel,
``bin_unc2``, is then the histogram of ``unc^2 * weights``); ``unweighted``
histograms unit weights (a stacked container's padded slots drop out as
out-of-range events do). A binned ``calc_mode`` re-bins binned weights
through a ``(calc size, apply size)`` transform, the joint histogram of the
events under the two binnings built at set-up (their dimensions must be
disjoint): one product per channel. ``astro_weights`` (``flux.astrophysical``)
are added to the weights. With either option the rate deferral declines,
and a binned calc mode does not stack.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE
from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.container import reduce_over_ranks
from pisa_tpu_torch.core.stage import Stage

__all__ = ["hist", "init_test"]


class hist(Stage):  # noqa: N801
    """Events (or a binned calc mode) -> binned histogram of 'weights' (+
    'errors' and 'bin_unc2' with sumw2). Options: apply_unc_weights,
    unweighted."""

    def __init__(self, apply_unc_weights=False, unweighted=False, **std_kwargs):
        expected_container_keys = ["weights"]
        if apply_unc_weights:
            expected_container_keys.append("unc_weights")
        super().__init__(
            expected_params=(),
            expected_container_keys=tuple(expected_container_keys),
            **std_kwargs,
        )
        self.apply_unc_weights = bool(apply_unc_weights)
        self.unweighted = bool(unweighted)
        if self.unweighted and self.is_map:
            raise NotImplementedError(
                "unweighted only implemented for event-wise calc")

    def setup_function(self):
        # the JAX package runs this product at Precision.HIGHEST; keep float32
        # CUDA matmuls in full float32 (TF32 keeps ~3 decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        if self.apply_mode is None:
            self.apply_mode = self.data["output_binning"]
        if self.is_map:
            self._setup_transform()
            return
        self.data.representation = "events"
        for container in self.data:
            container.cached_hist_matrix(self.apply_mode)

    def _setup_transform(self):
        """The binned calc mode's ``(calc size, apply size)`` transform per
        container: the joint histogram of its events under calc x apply
        (``pisa_tpu/stages/utils/hist.py:51-72``)."""
        if set(self.calc_mode.names) & set(self.apply_mode.names):
            raise ValueError(
                "calc and apply binnings must use disjoint dimensions")
        joint = self.calc_mode * self.apply_mode
        for container in self.data:
            container.representation = "events"
            counts = translation.histogram(
                [container[name] for name in joint.names], None, joint)
            container.representation = self.calc_mode
            container["hist_transform"] = counts.reshape(
                self.calc_mode.size, self.apply_mode.size)

    supports_stacked = True
    supports_shard = True

    def stacked_ok(self):
        # the binned calc mode keeps one transform per container
        return not self.is_map

    def _weights(self, container):
        """(w, the third sumw2 channel or None when it is w): the weights to
        histogram, with astro_weights added, unit weights when unweighted,
        and times unc_weights when apply_unc_weights."""
        weights = container["weights"]
        if "astro_weights" in container.keys:
            weights = weights + container["astro_weights"]
        if self.unweighted:
            # a stacked container's padded slots sit at the out-of-range
            # index, so their unit weights drop out of the histogram
            weights = torch.ones_like(weights)
        if not self.apply_unc_weights:
            return weights, None
        unc = container["unc_weights"]
        return unc * weights, torch.square(unc) * weights

    def _channels(self, container):
        """The weight channels in the last axis: (w, w^2[, unc^2 w]) with
        sumw2, else w alone."""
        w, unc2_w = self._weights(container)
        if self.error_method != "sumw2":
            return w
        chans = [w, torch.square(w)] + ([] if unc2_w is None else [unc2_w])
        return torch.stack(chans, dim=-1)

    def _store(self, container, res):
        """Writes the histogram channels `res` (as :meth:`_channels` made
        them) in the apply binning."""
        container.representation = self.apply_mode
        if self.error_method != "sumw2":
            container["weights"] = res
            return
        container["weights"] = res[..., 0]
        container["errors"] = torch.sqrt(res[..., 1])
        container["bin_unc2"] = res[..., 2 if self.apply_unc_weights else 0]

    def prepare_stacked(self, data):
        """The stacked one-hot membership matrix, once (where it fits the
        size budget), so that a template's histogram is one batched
        product."""
        if self.is_map:
            return
        if self.apply_mode is None:
            self.apply_mode = data["output_binning"]
        for container in data.containers:
            prev = container.representation
            container.representation = "events"
            try:
                container.cached_hist_matrix(self.apply_mode)
            finally:
                container.representation = prev

    def prepare_rate_defer(self, data, calc_binning, static_keys):
        """One-time set-up of the factorized histogram on the stacked set
        `data`: per category c the static

            S_c[g, b]  = sum of A0_e over the events e of c in calc cell g
                         and output bin b
            S2_c[g, b] = the same with A0_e^2 (the sumw2 channel)

        where A0 is the static per-event weight base (the initial weights
        times the static factors `static_keys`, e.g. ``weighted_aeff``). A
        template's histogram is then ``H[c] = s_c * rate[row_c] @ S_c``: one
        contraction in place of the grid -> events gather. The per-category
        scalar s_c (all parameter dependence of the non-rate weight
        factors, a scalar by the stages' ``stacked_rate_defer_safe``
        contract) is read off one reference event per category at every
        evaluation. Exact, because every event of a calc cell shares the
        cell's rate (the 'average' lookup, reference
        ``pisa/core/translation.py:228``), and through S2 for sumw2 because
        the rate enters each event's weight linearly.

        The matrices are computed on the host in float64 and cast, as in
        the JAX package (``hist.py:103-203``), and put on each stacked
        container as ``container.rate_defer``. Returns True when that was
        done for every container; on False no container keeps any of it."""
        if self.apply_mode is None:
            self.apply_mode = data["output_binning"]
        if self.apply_unc_weights or self.unweighted:
            return False
        prepared = self._rate_defer_inputs(data, calc_binning, static_keys)
        for sc in data.containers:
            if getattr(sc, "is_stacked", False):
                sc.rate_defer = prepared[id(sc)] if prepared else None
        return prepared is not None

    def _rate_defer_inputs(self, data, calc_binning, static_keys):
        """{id(container): rate_defer dict} for every container of `data`,
        or None when one of them cannot take the factorized histogram."""
        B = self.apply_mode.size
        G = calc_binning.size
        prepared = {}
        for sc in data.containers:
            if not getattr(sc, "is_stacked", False):
                return None
            if "astro_weights" in sc:
                return None
            C = sc.n_cats
            if C * G * B * np.dtype("float32").itemsize * 2 > 4_000_000_000:
                return None
            prev = sc.representation
            sc.representation = "events"
            try:
                gidx = sc.cached_flat_indices(calc_binning).cpu().numpy()
                bidx = sc.cached_flat_indices(self.apply_mode).cpu().numpy()
                # the loader resets weights = initial_weights at the start of
                # every evaluation, so the static base is initial_weights x
                # the static factors, not 'weights' as some run left it
                base = "initial_weights" if "initial_weights" in sc else "weights"
                A0 = sc[base].double().cpu().numpy()
                for k in static_keys:
                    A0 = A0 * sc[k].double().cpu().numpy()
            finally:
                sc.representation = prev
            A0 = np.where(np.isfinite(A0), A0, 0.0)
            valid = (gidx < G) & (bidx < B)
            comb = gidx.astype(np.int64) * B + bidx.astype(np.int64)
            S = np.zeros((C, G, B), dtype=FTYPE)
            S2 = np.zeros((C, G, B), dtype=FTYPE)
            # one reference event per category for the scalar ratio
            e0 = np.zeros(C, dtype=np.int64)
            a0 = np.ones(C, dtype=np.float64)
            for c in range(C):
                v = valid[c]
                S[c] = np.bincount(
                    comb[c][v], weights=A0[c][v], minlength=G * B
                ).reshape(G, B)
                S2[c] = np.bincount(
                    comb[c][v], weights=A0[c][v] ** 2, minlength=G * B
                ).reshape(G, B)
                vv = np.flatnonzero(v & (np.abs(A0[c]) > 0))
                if vv.size:
                    e0[c] = vv[np.argmax(np.abs(A0[c][vv]))]
                    a0[c] = A0[c][e0[c]]

            def put(x, dtype=TORCH_FTYPE):
                return torch.as_tensor(x, dtype=dtype, device=sc.device)

            prepared[id(sc)] = {
                "S": put(S),
                "S2": put(S2),
                # the reference events' places in the flattened (C * n_pad)
                # weights, and 1 / A0 there (0 where A0 is 0: s_c = 1)
                "e0": put(np.arange(C) * sc.n_pad + e0, torch.int64),
                "inv_a0": put(np.where(a0 != 0, 1.0 / a0, 0.0)),
                "a0_nonzero": put(a0 != 0, torch.bool),
                # on the host, for a sharded template
                # (parallel/sharding.py:shard_stacked_containers): the calc
                # grid's representation, each reference event's place on
                # the padded event axis and its A0
                "grid": hash(calc_binning),
                "e0_event": e0,
                "a0": a0,
            }
        return prepared or None

    def _apply_stacked_deferred(self, container, dr):
        """The factorized histogram of a container whose oscillation stage
        deferred its rate in this evaluation."""
        defer = container.rate_defer
        rate = dr["rate"]  # ([B,] R, G)
        lead = () if container.lanes is None else (container.lanes,)
        container.representation = "events"
        A = container["weights"]  # ([B,] C, n_pad) weights before the rate
        rate_c = rate.index_select(len(lead),
                                   container.row_tensor(dr["rows"]))
        sharded = container.shard is not None
        if sharded and defer["rate_slice"] is not None:
            g0, g1 = defer["rate_slice"]
            rate_c = rate_c[..., g0:g1]
        parts = [torch.einsum("...cg,cgb->...cb", rate_c, defer["S"])]
        if self.error_method == "sumw2":
            parts.append(torch.einsum("...cg,cgb->...cb",
                                      torch.square(rate_c), defer["S2"]))
        k = len(lead)
        A_e0 = A.reshape(lead + (-1,)).index_select(k, defer["e0"]) \
            * defer["inv_a0"]
        if sharded:
            # the ranks' partial channels and the category scalars' parts
            # (each from the rank that holds its reference event) summed in
            # one all_reduce; the unsharded route skips the cat and the
            # index_add, which would cost its captured value_and_grad 15
            # kernels a replay (PERF.md §6)
            scalars = torch.zeros(lead + (container.n_cats,), dtype=A.dtype,
                                  device=A.device).index_add(
                k, defer["e0_cats"], A_e0)
            total = reduce_over_ranks(
                container, torch.cat(parts + [scalars[..., None]], dim=-1))
            nb = parts[0].shape[-1]
            parts = [total[..., i * nb:(i + 1) * nb]
                     for i in range(len(parts))]
            A_e0 = total[..., -1]
        s = torch.where(defer["a0_nonzero"], A_e0, 1.0)
        hist_w = parts[0] * s[..., None]
        container.representation = self.apply_mode
        container["weights"] = hist_w
        # under deferral the events-representation weights lack the rate:
        # invalid, so that a later reader there re-translates instead of
        # taking them
        container.validity["weights"][hash("events")] = False
        if self.error_method == "sumw2":
            container["errors"] = torch.sqrt(
                parts[1] * torch.square(s)[..., None])
            container["bin_unc2"] = hist_w

    def _apply_stacked(self, container):
        """All categories in one batched op: (C, n) weights with the (C, n,
        size) one-hot -> (C, size), the sumw2 channel in the same product."""
        dr = container.deferred_rate
        if dr is not None:
            container.deferred_rate = None
            if container.rate_defer is None:
                raise RuntimeError(
                    "the oscillation stage deferred its rate, but this"
                    " container has no factorized-histogram matrices"
                )
            self._apply_stacked_deferred(container, dr)
            return
        container.representation = "events"
        res = container.stacked_histogram(self._channels(container),
                                          self.apply_mode,
                                          laned=container.lanes is not None)
        self._store(container, reduce_over_ranks(container, res))
        # histogramming does not invalidate the events representation
        container.validity["weights"][hash("events")] = True

    def _apply_transform(self, container):
        """Binned calc mode: each channel times the container's transform
        (with lanes, (B, calc) @ (calc, apply))."""
        container.representation = self.calc_mode
        w, unc2_w = self._weights(container)
        transform = container["hist_transform"]
        if container.lanes is not None:
            # static: the broadcast view's first lane is the transform
            transform = transform[0]
        hist_w = w @ transform
        if self.error_method == "sumw2":
            res = [hist_w, torch.square(w) @ transform]
            if unc2_w is not None:
                res.append(unc2_w @ transform)
            hist_w = torch.stack(res, dim=-1)
        self._store(container, hist_w)

    def apply_function(self):
        for container in self.data:
            if self.is_map:
                self._apply_transform(container)
                continue
            if getattr(container, "is_stacked", False):
                self._apply_stacked(container)
                continue
            container.representation = "events"
            chans = self._channels(container)
            matrix = container.cached_hist_matrix(self.apply_mode)
            laned = container.lanes is not None
            if matrix is not None:
                res = translation.histogram_matmul(chans, matrix, laned=laned)
            else:
                idx = container.cached_flat_indices(self.apply_mode)
                res = translation.histogram(None, chans, self.apply_mode,
                                            idx=idx, laned=laned)
            self._store(container, reduce_over_ranks(container, res))
            # histogramming does not invalidate the events representation
            container.validity["weights"][hash("events")] = True


def init_test(**param_kwargs):
    """Instantiation example."""
    return hist(calc_mode="events")
