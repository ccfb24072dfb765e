"""
Container stacking: a pipeline's per-category event containers as ONE
container whose tensors carry a leading category axis.

Counterpart of ``pisa_tpu/core/stacking.py``. The eager pipeline runs every
stage once per event category (12 containers on the IceCube-3y flagship), so
one template is ~12 copies of every per-event op chain, each op its own
kernel launch, and its reverse pass 12 more. Stacked, those are one chain
over ``(C, N)`` tensors: the same arithmetic in a twelfth of the launches.

Representation model
--------------------
A :class:`StackedContainer` holds, per key and representation, ONE tensor:

- events representation: shape ``(C, n_pad, ...)``, one row per category,
  padded to the largest category. Coordinate keys pad with NaN (the bin
  search maps NaN to the overflow sentinel, so padded events drop out of
  histograms and lookups); everything else pads with 0, so that
  ``weights *= anything`` stays 0 in padded slots.
- binned representations: shape ``(G, size, ...)``, where ``G`` may be less
  than ``C`` when several categories share their values (the stacked form of
  container linking, reference ``pisa/core/container.py:279``: oscillation
  probabilities depend only on (nubar, flavour), so 6 rows serve 12
  categories). ``rows[(key, rep)]`` maps category -> row:

  * ``None``: one shared tensor without a group axis (the calc-grid flux);
  * ``"cat"``: the leading axis is the category axis (``G == C``);
  * an int array ``(C,)``: the category -> group-row map.

Per-category scalar aux data (``nubar``, ``flav``) is kept as ``(C,)`` numpy
arrays; stacked-aware stage code reads it with
:meth:`StackedContainer.cat_aux`.

In an evaluation of lanes (``container.lanes``, ``core/container.py``) every
shape above gains a leading lane axis: ``(B, C, n_pad, ...)``, ``(B, G,
size, ...)``, ``(B, size, ...)``; rows maps, gathers and histograms act
behind it, so the lanes share every index and matrix.

Stages opt in through ``supports_stacked``/``stacked_ok()``
(``core/stage.py``); ``core/template.py:CompiledTemplate`` stacks only when
every traced stage does, and says so (``CompiledTemplate.stacked``). The
eager pipeline never stacks. Everything a template evaluation needs beyond
the stage math (row maps, gather indices, one-hot matrices) is built on the
device once and cached, so an evaluation moves nothing from the host.

The JAX package's pull-transpose gather (``stacking.py:267``) is dead code
there and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.container import (
    _HIST_MATRIX_MAX_BINS,
    _HIST_MATRIX_MAX_ELEMS,
    Container,
    ContainerSet,
    _rep_hash,
    reduce_over_ranks,
)

__all__ = ["StackedContainer", "StackingError", "build_stacked_set"]


class StackingError(ValueError):
    """A ContainerSet that cannot be stacked; the compiled template then
    runs per container."""


def _is_cat(rows):
    return isinstance(rows, str) and rows == "cat"


class StackedContainer(Container):
    """One container standing in for C per-category containers (the module
    docstring has the tensor and rows model)."""

    is_stacked = True

    def __init__(self, name, cat_names, n_pad, representation="events",
                 device="cuda"):
        super().__init__(name, representation=representation, device=device)
        self.cat_names = list(cat_names)
        self.n_cats = len(self.cat_names)
        self.n_pad = int(n_pad)
        #: (key, rep_hash) -> None | "cat" | int array (C,)
        self.rows = {}
        #: aux key -> (C,) numpy array of per-category scalars
        self._cat_aux = {}
        #: the oscillation stage's grid rate, handed to the histogram stage
        #: within one evaluation when ``rate_defer`` is set:
        #: ``{"rate": (R, G) tensor, "rows": (C,) int array}``
        self.deferred_rate = None
        #: the factorized histogram's static inputs
        #: (``stages/utils/hist.py:prepare_rate_defer``), or None when rate
        #: deferral is off for the template that owns this container
        self.rate_defer = None
        #: category -> row maps as device tensors, by their bytes
        self._row_tensors = {}
        #: (C, n_pad) bool on the device, True at each category's real
        #: events and False at its padding slots (build_stacked_set sets it)
        self.real_events = None

    # -- aux -------------------------------------------------------------
    def cat_aux(self, key):
        """Per-category values of an aux scalar as a (C,) numpy array."""
        if key in self._cat_aux:
            return self._cat_aux[key]
        if key in self._aux_data:
            return np.asarray([self._aux_data[key]] * self.n_cats)
        raise KeyError(f"No aux data {key!r} in stacked container")

    def __getitem__(self, key):
        if key in self._cat_aux:
            return self._cat_aux[key]
        return super().__getitem__(key)

    def __contains__(self, key):
        return key in self._cat_aux or super().__contains__(key)

    @property
    def all_keys_incl_aux_data(self):
        return super().all_keys_incl_aux_data + list(self._cat_aux)

    # -- shape -----------------------------------------------------------
    @property
    def shape(self):
        if self.is_map:
            return self._representation.shape
        return (self.n_cats, self.n_pad)

    # -- state -------------------------------------------------------------
    def state(self):
        return (super().state(), dict(self.rows), self.deferred_rate)

    def set_state(self, state):
        base, rows, deferred_rate = state
        super().set_state(base)
        self.rows = dict(rows)
        self.deferred_rate = deferred_rate

    # -- get / set -------------------------------------------------------
    def row_tensor(self, rows):
        """An int (C,) category -> row map as an int64 tensor on the
        device, uploaded once per distinct map."""
        rows = np.asarray(rows, dtype=np.int64)
        key = rows.tobytes()
        if key not in self._row_tensors:
            self._row_tensors[key] = torch.as_tensor(rows, device=self.device)
        return self._row_tensors[key]

    def _store(self, key, data, rows):
        h = _rep_hash(self._representation)
        self._data.setdefault(key, {})[h] = data
        if key not in self.translation_modes:
            self.translation_modes[key] = (
                "sum" if key in self.sum_mode_keys else "average"
            )
        self.rows[(key, h)] = rows
        self.mark_changed(key)

    def set_stacked(self, key, data, rows):
        """Store `data` for `key` in the current representation with an
        explicit category -> row map (see the module docstring)."""
        if rows is not None and not _is_cat(rows):
            rows = np.asarray(rows, dtype=np.int32)
            if rows.shape != (self.n_cats,):
                raise ValueError(
                    f"rows must be (C,)=({self.n_cats},); got {rows.shape}"
                )
        self._store(key, self._lane_value(key, self._to_device(data)), rows)

    @property
    def _lead(self):
        """The lane axis of the evaluation in progress: () or (B,)."""
        return () if self.lanes is None else (self.lanes,)

    def __setitem__(self, key, data):
        """Plain writes infer the rows entry from the shape: an events
        write must be (C, n_pad, ...) ('cat'); a binned write is 'cat' when
        shaped (C, size, ...) and shared when shaped (size, ...)."""
        if key in self._cat_aux:
            raise KeyError(f"Key {key!r} is per-category aux data")
        if self.is_map and key in self._representation.names:
            raise ValueError(f"Cannot set {key!r}: it is a binning dimension")
        data = self._lane_value(key, self._to_device(data))
        lead = self._lead
        shape = tuple(data.shape)[len(lead):]
        if self.is_map:
            size = self.local_size(self._representation)
            bshape = tuple(self._representation.shape)
            nb = len(bshape)
            # unflattened (C,) + bshape + extra, or bshape + extra
            if shape[:1] == (self.n_cats,) and shape[1:1 + nb] == bshape:
                data = data.reshape(lead + (self.n_cats, size)
                                    + shape[1 + nb:])
            elif shape[:nb] == bshape and shape[:1] != (size,):
                data = data.reshape(lead + (size,) + shape[nb:])
            shape = tuple(data.shape)[len(lead):]
            if shape[:2] == (self.n_cats, size):
                rows = "cat"
            elif shape[:1] == (size,):
                rows = None
            else:
                raise ValueError(
                    f"Ambiguous stacked binned write for {key!r}: shape"
                    f" {shape} vs C={self.n_cats}, size={size}; use"
                    " set_stacked(key, data, rows)"
                )
        else:
            if shape[:2] != (self.n_cats, self.n_pad):
                raise ValueError(
                    f"Stacked events write for {key!r} must be (C, n_pad,"
                    f" ...)=({self.n_cats}, {self.n_pad}, ...); got {shape}"
                )
            rows = "cat"
        self._store(key, data, rows)

    def expanded(self, key):
        """`key` in the current representation with the category axis
        materialized (or broadcastable): a shared tensor as it is, a grouped
        one gathered to (C, ...)."""
        values = self[key]
        rows = self.rows.get((key, _rep_hash(self._representation)))
        if rows is None or _is_cat(rows):
            return values
        return values.index_select(len(self._lead), self.row_tensor(rows))

    # -- translation -------------------------------------------------------
    def translate(self, key, src_representation):
        dest = self._representation
        if _rep_hash(src_representation) == _rep_hash(dest):
            return
        mode = self.translation_modes.get(key, "average")
        from_map = isinstance(src_representation, MultiDimBinning)
        to_map = isinstance(dest, MultiDimBinning)
        src_h = _rep_hash(src_representation)
        values = self._data[key][src_h]
        rows = self.rows.get((key, src_h))
        laned = key in self._laned

        sharded = self.shard is not None
        if from_map and not to_map and mode == "average":
            if sharded and src_h in self.shard.grids:
                raise NotImplementedError(
                    f"{key!r}: this rank holds a slice of {src_representation}"
                    " but all of its events; a sharded template splits the"
                    " calc grid only where the histogram contracts it")
            out = self._stacked_binned_to_array(
                values, rows, src_representation, laned
            )
        elif to_map and not from_map:
            if sharded and mode == "average":
                raise NotImplementedError(
                    f"{key!r}: a mean from this rank's slice of the events"
                    f" to {dest} needs the other ranks' counts; a sharded"
                    " template translates events to a binning in sum mode"
                    " only")
            out = reduce_over_ranks(self, self.stacked_histogram(
                values, dest, averaged=(mode == "average"), laned=laned
            ))
        else:
            raise NotImplementedError(
                f"stacked translation {src_representation} -> {dest}"
                f" (mode={mode})"
            )
        dest_h = _rep_hash(dest)
        self._data[key][dest_h] = out
        self.rows[(key, dest_h)] = "cat"
        self.validity[key][dest_h] = True

    def _gather_indices(self, binning, rows):
        """For the stacked events under `binning` and a rows map: the
        (C * n_pad,) indices into the ``(G * size, ...)`` flattened binned
        values and the (C, n_pad) mask of padded and out-of-range events;
        parameter-independent, so cached like the flat indices."""
        rows_key = None if rows is None else (
            "cat" if _is_cat(rows) else np.asarray(rows).tobytes()
        )
        key = (_rep_hash("events"), _rep_hash(binning), "gather", rows_key)
        if key not in self._flatidx:
            idx = self.cached_flat_indices(binning, "events")
            size = binning.size
            gidx = idx.clamp(0, size - 1)
            if rows is not None:
                row = (
                    torch.arange(self.n_cats, device=self.device)
                    if _is_cat(rows) else self.row_tensor(rows)
                )
                gidx = row[:, None] * size + gidx
            self._flatidx[key] = (gidx.reshape(-1), idx >= size)
            self._flatidx_names[key] = tuple(binning.names)
        return self._flatidx[key]

    def _stacked_binned_to_array(self, values, rows, src_binning,
                                 laned=False):
        """'average'-mode binned -> events: every category's lookup, with
        the rows indirection folded in, as one gather; padded and
        out-of-range events get 0. (``index_select``: its reverse pass is an
        ``index_add_`` of the event cotangents into the grid cells.) With
        `laned`, `values` carries a leading lane axis and so does the
        result."""
        gidx, invalid = self._gather_indices(src_binning, rows)
        lead = tuple(values.shape[:1]) if laned else ()
        k = len(lead)
        if rows is not None:
            values = values.reshape(lead + (-1,) + tuple(values.shape[k + 2:]))
        out = values.index_select(k, gidx)
        extra = tuple(values.shape[k + 1:])
        out = out.reshape(lead + (self.n_cats, self.n_pad) + extra)
        invalid = invalid.reshape(invalid.shape + (1,) * len(extra))
        return torch.where(invalid, 0.0, out)

    def stacked_histogram(self, values, binning, averaged=False,
                          laned=False):
        """(C, n_pad[, k]) event values -> (C, size[, k]) per-category
        histograms: one batched product with the cached stacked one-hot
        where there is one, otherwise one scatter-add with each category
        offset into its own block of bins. With `laned`, `values` and the
        result carry a leading lane axis."""
        matrix = self.cached_hist_matrix(binning, events_rep="events")
        if matrix is not None and not averaged:
            return translation.histogram_matmul_stacked(values, matrix,
                                                        laned=laned)
        size = binning.size
        C = self.n_cats
        key = (_rep_hash("events"), _rep_hash(binning), "offset")
        if key not in self._flatidx:
            idx = self.cached_flat_indices(binning, "events")
            off = (
                torch.arange(C, device=self.device)[:, None] * (size + 1)
                + idx.clamp(0, size)
            )
            self._flatidx[key] = off.reshape(-1)
            self._flatidx_names[key] = tuple(binning.names)
        off = self._flatidx[key]
        lead = tuple(values.shape[:1]) if laned else ()
        extra = tuple(values.shape[len(lead) + 2:])

        def scatter(flat_values, lead):
            k = len(lead)
            rest = tuple(flat_values.shape[k + 1:])
            out = torch.zeros(lead + (C * (size + 1),) + rest,
                              dtype=values.dtype, device=self.device)
            out = out.index_add_(k, off, flat_values)
            return out.reshape(lead + (C, size + 1) + rest).narrow(
                k + 1, 0, size)

        out = scatter(values.reshape(lead + (C * self.n_pad,) + extra), lead)
        if averaged:
            counts = scatter(torch.ones(C * self.n_pad, dtype=values.dtype,
                                        device=self.device), ())
            counts = counts.reshape(counts.shape + (1,) * len(extra))
            out = torch.where(
                counts > 0, out / torch.where(counts > 0, counts, 1.0), 0.0
            )
        return out

    def cached_hist_matrix(self, binning, events_rep="events"):
        """Stacked one-hot membership matrix (C, n_pad, size); padded and
        out-of-range events get all-zero rows. Budgeted on the total
        element count like the per-container version; None beyond it."""
        size = binning.size
        key = (_rep_hash(events_rep), _rep_hash(binning), "hist_matrix")
        if key not in self._flatidx:
            idx = self.cached_flat_indices(binning, events_rep)
            if (
                size > _HIST_MATRIX_MAX_BINS
                or idx.numel() * size > _HIST_MATRIX_MAX_ELEMS
            ):
                return None
            matrix = torch.nn.functional.one_hot(idx, size + 1)[..., :size]
            self._flatidx[key] = matrix.to(TORCH_FTYPE)
            self._flatidx_names[key] = tuple(binning.names)
        return self._flatidx[key]


# ---------------------------------------------------------------------------
# building the stacked set
# ---------------------------------------------------------------------------


def _events_size(container):
    ev_h = _rep_hash("events")
    for key, per in container._data.items():
        if ev_h in per and container.validity.get(key, {}).get(ev_h, False):
            return int(per[ev_h].shape[0])
    raise StackingError(
        f"container {container.name!r} has no valid events-rep tensor"
    )


def _pad_stack(tensors, n_pad, pad_value):
    """Stack per-category tensors along a new leading axis, the event axis
    padded to `n_pad` with `pad_value`."""
    first = tensors[0]
    out = torch.full((len(tensors), n_pad) + tuple(first.shape[1:]),
                     pad_value, dtype=first.dtype, device=first.device)
    for c, tensor in enumerate(tensors):
        out[c, : tensor.shape[0]] = tensor
    return out


def _dedup_rows(tensors):
    """Group per-category tensors by identity, then by value: returns
    ``(unique list, rows)`` with ``rows[c]`` the index into the list."""
    uniq = []
    uniq_ids = {}
    rows = np.empty(len(tensors), dtype=np.int32)
    for c, tensor in enumerate(tensors):
        key = id(tensor)
        if key not in uniq_ids:
            # value-level merge (equal values written per container by a
            # stage that does not link)
            found = None
            for gi, rep in enumerate(uniq):
                if (rep.shape == tensor.shape and rep.dtype == tensor.dtype
                        and torch.equal(rep, tensor)):
                    found = gi
                    break
            if found is None:
                uniq.append(tensor)
                found = len(uniq) - 1
            uniq_ids[key] = found
        rows[c] = uniq_ids[key]
    return uniq, rows


def build_stacked_set(container_set, coord_keys=(), name=None,
                      exclude_keys=(), pad_multiple=1):
    """A ContainerSet holding ONE StackedContainer that stands in for all
    containers of `container_set` (which is not changed).

    Parameters
    ----------
    container_set : ContainerSet
    coord_keys : collection of str
        Event keys that are binning coordinates (padded with NaN, so that
        padded events fall outside every binning); all other float keys pad
        with 0.
    pad_multiple : int
        Round the padded event count up to a multiple of this (the mesh
        size of a sharded template, so that the event axis splits evenly
        over the ranks; ``pisa_tpu/core/stacking.py:472``); the extra slots
        pad as the others do and drop out of every reduction.
    exclude_keys : collection of str
        Keys left out of the stacked copy (``Stage.stacking_exclude_keys``).

    Raises
    ------
    StackingError
        When the containers are not uniform enough to stack.
    """
    containers = list(container_set.containers)
    if len(containers) < 2:
        raise StackingError("nothing to stack (fewer than 2 containers)")
    if container_set.linked_containers:
        raise StackingError("cannot stack while containers are linked")

    coord_keys = set(coord_keys)
    exclude_keys = set(exclude_keys)
    key_sets = {tuple(sorted(set(c._data) - exclude_keys))
                for c in containers}
    if len(key_sets) != 1:
        raise StackingError(
            f"containers have differing key sets: {sorted(key_sets)}"
        )
    if len({tuple(sorted(c._aux_data)) for c in containers}) != 1:
        raise StackingError("containers have differing aux-data keys")

    ev_h = _rep_hash("events")
    pad_multiple = max(1, int(pad_multiple))
    n_pad = -(-max(_events_size(c) for c in containers) // pad_multiple) \
        * pad_multiple
    sc = StackedContainer(
        name or container_set.name or "stacked",
        [c.name for c in containers],
        n_pad,
        device=container_set.device,
    )
    # every representation any container knows
    for c in containers:
        sc._representations.update(c._representations)

    first = containers[0]

    for key in first._data:
        if key in exclude_keys:
            continue
        if key in first.translation_modes:
            sc.translation_modes[key] = first.translation_modes[key]
        # the representations in which every container has this key
        common_hashes = set(first._data[key])
        for c in containers[1:]:
            common_hashes &= set(c._data[key])
        for h in common_hashes:
            tensors = [c._data[key][h] for c in containers]
            valid = all(
                c.validity.get(key, {}).get(h, False) for c in containers
            )
            if h == ev_h:
                floating = tensors[0].dtype.is_floating_point
                pad_value = (
                    float("nan") if floating and key in coord_keys else 0
                )
                stacked = _pad_stack(tensors, n_pad, pad_value)
                rows = "cat"
            else:
                uniq, rows_arr = _dedup_rows(tensors)
                if len(uniq) == 1:
                    stacked = uniq[0]
                    rows = None
                else:
                    shapes = {tuple(t.shape) for t in uniq}
                    if len(shapes) != 1:
                        raise StackingError(
                            f"key {key!r}: mixed shapes {shapes} in a binned"
                            " representation"
                        )
                    stacked = torch.stack(uniq, dim=0)
                    rows = (
                        "cat" if np.array_equal(
                            rows_arr, np.arange(len(containers))
                        ) else rows_arr
                    )
            sc._data.setdefault(key, {})[h] = stacked
            sc.rows[(key, h)] = rows
            sc.validity.setdefault(key, {})[h] = valid

    sizes = torch.as_tensor([_events_size(c) for c in containers],
                            device=sc.device)
    sc.real_events = torch.arange(n_pad, device=sc.device) < sizes[:, None]

    # aux data: shared scalars stay scalars; per-category values become (C,)
    for key in first._aux_data:
        vals = [c._aux_data[key] for c in containers]
        if all(v == vals[0] for v in vals[1:]):
            sc._aux_data[key] = vals[0]
        else:
            sc._cat_aux[key] = np.asarray(vals)

    out = ContainerSet(container_set.name, device=container_set.device,
                       containers=[sc])
    for k, v in container_set._glob_aux.items():
        out[k] = v
    return out
