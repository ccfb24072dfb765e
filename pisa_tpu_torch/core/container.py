"""
Containers: per-event-category data with several simultaneous
representations (event arrays and binned grids), lazily translated by the
torch translation ops.

Counterpart of ``pisa_tpu/core/container.py`` (reference
``pisa/core/container.py:199,363,451``), with the same semantics:

- a variable lives in one or more representations; reading it in an invalid
  representation translates it from a valid one;
- per-variable translation mode 'average' (values, e.g. probabilities) or
  'sum' (additive weights);
- aux data (scalars like nubar/flav) is available in every representation;
- reading a binning-dimension name in a binned representation returns the
  unrolled weighted-center grid;
- ``link_containers`` groups physically identical containers so shared
  quantities are computed once (``VirtualContainer``).

Lanes (the batched fits' B independent parameter points, evaluated in one
program by ``core/template.py``): while a compiled template evaluates lanes
it sets ``lanes`` = B on every container. Then every value a stage reads
carries a leading lane axis: a value written in this evaluation has it, a
value from before (the hoisted stages' static data, a binning coordinate)
is returned as a broadcast view ``expand(B, ...)``, which costs no memory;
and every value a stage writes must carry it. So stage code sees one shape
convention, ``(B, *shape)``. A written floating value is stored in
``TORCH_FTYPE``. A lane's magnitudes are (B, 1) float64 tensors, which,
unlike the 0-d ones of a single point, would promote float32 data to
float64: stages take them through ``core.stage.in_data_type``, so that a
lane computes in the data's type as its single point does. A laned value
translates between events and a binning with its lane axis folded into the
channels (a lookup, a histogram or a resampling between two binnings per
container, or the stacked container's own ops, ``core/stacking.py``).

Variables are torch tensors on the container set's device. Host arrays
(numpy) are uploaded when set, floating ones in ``TORCH_FTYPE`` (as the JAX
package's arrays take FTYPE); a tensor on another device is refused rather
than moved.

A sharded template's containers (``parallel/sharding.py``) hold one rank's
slice: their :class:`Shard` says which slice of the padded event axis, and
of which binnings' flat points, they hold. The coordinates of a sharded
binning are that slice of its grid, and a sum-mode translation from the
events to a binning sums over the ranks; the mean-mode one, which would need
the ranks' counts too, raises.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from pisa_tpu_torch import TORCH_FTYPE
from pisa_tpu_torch.core import translation
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.map import Map, MapSet

__all__ = ["Container", "ContainerSet", "VirtualContainer", "Shard",
           "resolve_device"]

#: Largest dense one-hot histogram matrix per container, in elements
#: (5e7 elements = 200 MB in fp32), and in bins; beyond either the histogram
#: is a scatter-add.
_HIST_MATRIX_MAX_ELEMS = 50_000_000
_HIST_MATRIX_MAX_BINS = 512


def _rep_hash(rep):
    return hash(rep)


def resolve_device(device):
    """`device` as a concrete torch.device (``"cuda"`` -> the current card's
    index). A CUDA device without a card raises; nothing falls back to the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available;"
                " pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Shard:
    """One rank's slice of a sharded container (``parallel/sharding.py``).

    mesh : parallel.sharding.Mesh
        The ranks the container is split over, and this one's place; its
        ``all_reduce_sum(x)`` sums `x` over them.
    events : (start, stop)
        The slice of the padded event axis this rank holds.
    n_events : int
        The padded event axis's length over all ranks.
    grids : {rep hash: (start, stop)}
        The binnings whose flat points are split too, and this rank's
        slice of each.
    """

    mesh: object
    events: tuple
    n_events: int
    grids: dict = field(default_factory=dict)

    @property
    def key(self):
        """What tells this slice's host-side caches from another's."""
        return (self.mesh.rank, self.mesh.size, self.events,
                tuple(sorted(self.grids.items())))


def reduce_over_ranks(container, values):
    """`values` summed over the ranks of a sharded `container` (one
    differentiable ``all_reduce``, ``core/collectives.py``, over its
    shard's mesh); as it is on a container that is not sharded."""
    shard = getattr(container, "shard", None)
    if shard is None:
        return values
    return shard.mesh.all_reduce_sum(values)


class Container:
    """Data for one event category ('nue_cc', ...).

    Parameters
    ----------
    name : str
    representation : 'events' or MultiDimBinning
    device : torch.device or str
    """

    valid_translation_modes = ("average", "sum")
    #: variables that default to 'sum' translation (additive quantities)
    sum_mode_keys = ("weights", "initial_weights", "errors")

    def __init__(self, name, representation="events", device="cuda"):
        self.name = str(name)
        self.device = resolve_device(device)
        self._representations = {}
        self._data = {}  # key -> {rep_hash: tensor}
        self.validity = {}  # key -> {rep_hash: bool}
        self.translation_modes = {}
        self._aux_data = {}
        self.linked = False
        self._representation = None
        #: param-independent flat bin indices and one-hot matrices, cached
        #: across template evaluations: cache key -> tensor
        self._flatidx = {}
        #: cache key -> coordinate names the entry depends on
        self._flatidx_names = {}
        #: the number of lanes of the evaluation in progress (None: one
        #: parameter point); set by the compiled template
        self.lanes = None
        #: keys written with the lane axis in the evaluation in progress
        self._laned = set()
        #: this rank's slice of a sharded template's container (:class:`Shard`),
        #: or None
        self.shard = None
        self.representation = representation

    # -- representation handling --------------------------------------------
    @property
    def representation(self):
        return self._representation

    @representation.setter
    def representation(self, rep):
        if not (isinstance(rep, MultiDimBinning) or rep == "events"):
            raise ValueError(
                "Representation must be 'events' or a MultiDimBinning; got"
                f" {rep!r}"
            )
        self._representations[_rep_hash(rep)] = rep
        self._representation = rep

    @property
    def is_map(self):
        return isinstance(self._representation, MultiDimBinning)

    @property
    def representations(self):
        return tuple(self._representations.values())

    @property
    def representation_keys(self):
        return tuple(self._representations.keys())

    @property
    def shape(self):
        if self.is_map:
            return self._representation.shape
        for key, per_rep in self._data.items():
            arr = per_rep.get(_rep_hash(self._representation))
            if arr is not None:
                return (arr.shape[1 if key in self._laned else 0],)
        return None

    def local_size(self, binning):
        """The number of `binning`'s flat points this container holds: all,
        or this rank's slice where the binning is sharded."""
        grid = None if self.shard is None else self.shard.grids.get(
            _rep_hash(binning))
        return binning.size if grid is None else grid[1] - grid[0]

    @property
    def size(self):
        if self.is_map:
            return self._representation.size
        shape = self.shape
        return None if shape is None else int(np.prod(shape))

    @property
    def num_dims(self):
        return self._representation.num_dims if self.is_map else 1

    # -- keys ----------------------------------------------------------------
    @property
    def keys(self):
        """Variables valid in the current representation (plus binning dims
        when binned)."""
        h = _rep_hash(self._representation)
        out = [k for k, valid in self.validity.items() if valid.get(h, False)]
        if self.is_map:
            out.extend(self._representation.names)
        return out

    @property
    def all_keys(self):
        return list(self._data.keys())

    @property
    def all_keys_incl_aux_data(self):
        return self.all_keys + list(self._aux_data.keys())

    @property
    def keys_incl_aux_data(self):
        return self.keys + list(self._aux_data.keys())

    def __contains__(self, key):
        return key in self._data or key in self._aux_data

    def __iter__(self):
        return iter(self.keys)

    # -- aux data -------------------------------------------------------------
    def set_aux_data(self, key, val):
        """Representation-independent scalar metadata (e.g. nubar, flav)."""
        if key in self._data:
            raise KeyError(f"Key {key!r} already used for a variable")
        self._aux_data[key] = val

    # -- get / set ------------------------------------------------------------
    def __getitem__(self, key):
        if self.is_map and key in self._representation.names:
            return self._with_lanes(key, self._binning_coord(key))
        if key not in self._data:
            if key in self._aux_data:
                return self._aux_data[key]
            raise KeyError(
                f"Key {key!r} not in Container {self.name!r}; have"
                f" {self.all_keys_incl_aux_data}"
            )
        h = _rep_hash(self._representation)
        if not self.validity[key].get(h, False):
            self.auto_translate(key)
        return self._with_lanes(key, self._data[key][h])

    def _with_lanes(self, key, value):
        """`value` as a stage sees it: in an evaluation of lanes, a value
        without the lane axis as a broadcast view over the lanes."""
        if self.lanes is None or key in self._laned:
            return value
        return value.expand((self.lanes,) + tuple(value.shape))

    def _lane_value(self, key, data):
        """In an evaluation of lanes, a written value: checked to carry the
        lane axis first, and stored in ``TORCH_FTYPE`` if floating."""
        if self.lanes is None:
            return data
        if data.dim() == 0 or data.shape[0] != self.lanes:
            raise ValueError(
                f"Container {self.name!r} evaluates {self.lanes} lanes; the"
                f" value written to {key!r} has shape {tuple(data.shape)},"
                " without the lane axis first"
            )
        if data.is_floating_point() and data.dtype != TORCH_FTYPE:
            data = data.to(TORCH_FTYPE)
        return data

    def __setitem__(self, key, data):
        if self.is_map and key in self._representation.names:
            raise ValueError(f"Cannot set {key!r}: it is a binning dimension")
        if key in self._aux_data:
            raise KeyError(f"Key {key!r} is aux data; cannot set as variable")
        h = _rep_hash(self._representation)
        data = self._lane_value(key, self._to_device(data))
        self._data.setdefault(key, {})[h] = self._flatten(data)
        if key not in self.translation_modes:
            self.translation_modes[key] = (
                "sum" if key in self.sum_mode_keys else "average"
            )
        self.mark_changed(key)

    def _to_device(self, data):
        if isinstance(data, torch.Tensor):
            if data.device != self.device:
                raise ValueError(
                    f"Container {self.name!r} lives on {self.device}; got a"
                    f" tensor on {data.device}"
                )
            return data
        arr = np.asarray(data)
        dtype = TORCH_FTYPE if np.issubdtype(arr.dtype, np.floating) else None
        return torch.as_tensor(arr, dtype=dtype, device=self.device)

    def _flatten(self, data):
        if self.is_map:
            k = 0 if self.lanes is None else 1
            bshape = tuple(self._representation.shape)
            if tuple(data.shape[k:k + len(bshape)]) == bshape:
                return data.reshape(tuple(data.shape[:k]) + (-1,)
                                    + tuple(data.shape[k + len(bshape):]))
        return data

    def mark_changed(self, key):
        """Current representation becomes the only valid one for `key` (in
        an evaluation of lanes, a value with the lane axis)."""
        self.validity[key] = {_rep_hash(self._representation): True}
        if self.lanes is not None:
            self._laned.add(key)
        # a rewritten coordinate invalidates index caches built on it
        self.drop_index_caches({key})

    def mark_valid(self, key):
        self.validity.setdefault(key, {})[
            _rep_hash(self._representation)] = True

    def drop_index_caches(self, keys):
        """Forget the cached indices built on any coordinate in `keys`."""
        stale = [k for k, names in self._flatidx_names.items()
                 if not keys.isdisjoint(names)]
        for k in stale:
            del self._flatidx[k]
            del self._flatidx_names[k]

    # -- state, for template evaluations --------------------------------------
    def state(self):
        """The variables, their validity and the representation (not the
        index caches, which are parameter-independent), as a value that
        :meth:`set_state` installs."""
        return (
            {k: dict(v) for k, v in self._data.items()},
            {k: dict(v) for k, v in self.validity.items()},
            self._representation,
            dict(self._representations),
            dict(self.translation_modes),
            frozenset(self._laned),
        )

    def set_state(self, state):
        """Install a :meth:`state`; index caches built on a coordinate whose
        tensors differ between the two states are dropped."""
        data, validity, rep, reps, modes, laned = state

        def same(a, b):
            return (a is None) == (b is None) and (
                a is None or (a.keys() == b.keys()
                              and all(a[h] is b[h] for h in a))
            )

        self.drop_index_caches(
            {k for k in set(data) | set(self._data)
             if not same(data.get(k), self._data.get(k))}
        )
        self._data = {k: dict(v) for k, v in data.items()}
        self.validity = {k: dict(v) for k, v in validity.items()}
        self._representation = rep
        self._representations = dict(reps)
        self.translation_modes = dict(modes)
        self._laned = set(laned)

    def _binning_coord(self, key):
        """The unrolled weighted-center grid of binning dimension `key` (this
        rank's slice of it, where the binning is sharded), uploaded once per
        binning."""
        binning = self._representation
        cache_key = (_rep_hash(binning), "grid", key)
        if cache_key not in self._flatidx:
            points = self.unroll_binning(key, binning)
            if self.shard is not None and _rep_hash(binning) in \
                    self.shard.grids:
                points = points[slice(*self.shard.grids[_rep_hash(binning)])]
            self._flatidx[cache_key] = torch.as_tensor(
                np.ascontiguousarray(points),
                dtype=TORCH_FTYPE,
                device=self.device,
            )
        return self._flatidx[cache_key]

    @staticmethod
    def unroll_binning(key, binning):
        """The weighted centers of binning dimension `key` at every bin,
        flattened (a host array)."""
        grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
        return grid[binning.index(key)].ravel()

    # -- translation ----------------------------------------------------------
    def auto_translate(self, key):
        src = None
        for h, valid in self.validity[key].items():
            if valid:
                src = self._representations[h]
                break
        if src is None:
            raise ValueError(f"No valid representation for {key!r}")
        self.translate(key, src)

    def translate(self, key, src_representation):
        """Translate `key` from `src_representation` into the current one;
        both end up valid (reference ``container.py:806``)."""
        dest = self._representation
        if _rep_hash(src_representation) == _rep_hash(dest):
            return
        mode = self.translation_modes.get(key, "average")
        from_map = isinstance(src_representation, MultiDimBinning)
        to_map = isinstance(dest, MultiDimBinning)
        if mode == "average":
            if from_map and to_map:
                out = self.resample(key, src_representation, dest)
            elif to_map:
                out = self.array_to_binned(key, src_representation, dest)
            elif from_map:
                out = self.binned_to_array(key, src_representation, dest)
            else:
                raise NotImplementedError(
                    f"average translation {src_representation} -> {dest}"
                )
        elif mode == "sum":
            if to_map and not from_map:
                out = self.array_to_binned(key, src_representation, dest,
                                           averaged=False)
            else:
                raise NotImplementedError(
                    f"sum translation {src_representation} -> {dest}"
                )
        else:
            raise ValueError(f"Unknown translation mode {mode!r}")
        self._data[key][_rep_hash(dest)] = out
        self.validity[key][_rep_hash(dest)] = True

    def _translated(self, key, src_representation, op):
        """``op(values)`` of `key`'s values in `src_representation`, a
        translation by rows: a laned key's lane axis joins the trailing
        channels, (size, rest * B), and leaves them again after it."""
        values = self._data[key][_rep_hash(src_representation)]
        if key not in self._laned:
            return op(values)
        laned_shape = tuple(values.shape)
        out = op(values.movedim(0, -1).reshape(laned_shape[1], -1))
        return out.reshape(out.shape[:1] + laned_shape[2:]
                           + laned_shape[:1]).movedim(-1, 0)

    def array_to_binned(self, key, src_representation, dest_representation,
                        averaged=True):
        """`key`'s events in `src_representation` histogrammed into the
        binning `dest_representation` (their mean per bin if `averaged`,
        else their sum), not stored; on a sharded container the sum over
        the ranks, and a mean raises."""
        from_events = not isinstance(src_representation, MultiDimBinning)
        if self.shard is not None and from_events and averaged:
            raise NotImplementedError(
                f"{key!r}: a mean from this rank's slice of the events to"
                f" {dest_representation} needs the other ranks' counts; a"
                " sharded template translates events to a binning in sum"
                " mode only")
        def histogram(values):
            return self._array_to_binned(values, src_representation,
                                         dest_representation, averaged)

        out = self._translated(key, src_representation, histogram)
        return reduce_over_ranks(self, out) if from_events else out

    def binned_to_array(self, key, src_representation, dest_representation):
        """`key`'s values on the binning `src_representation` looked up at
        the events of `dest_representation` (0 out of range), not
        stored."""
        idx = self.cached_flat_indices(src_representation,
                                       dest_representation)

        def lookup(values):
            return translation.lookup(None, values, src_representation,
                                      idx=idx)

        return self._translated(key, src_representation, lookup)

    def resample(self, key, src_representation, dest_representation):
        """`key`'s values on the binning `src_representation` resampled onto
        the binning `dest_representation` (:func:`translation.resample`),
        not stored."""
        old = self._sample_arrays(src_representation,
                                  src_representation.names)
        new = self._sample_arrays(dest_representation,
                                  dest_representation.names)

        def resample(values):
            return translation.resample(values, old, src_representation, new,
                                        dest_representation)

        return self._translated(key, src_representation, resample)

    def _sample_arrays(self, rep, names):
        """Coordinate tensors for `names` as seen in representation `rep`
        (without a lane axis: coordinates are static)."""
        prev, lanes = self._representation, self.lanes
        self._representation, self.lanes = rep, None
        try:
            return [self[n] for n in names]
        finally:
            self._representation, self.lanes = prev, lanes

    def cached_flat_indices(self, binning, events_rep="events"):
        """Sanitized flat bin indices of this container's events under
        `binning`, cached across calls (they are param-independent)."""
        key = (_rep_hash(events_rep), _rep_hash(binning))
        if key not in self._flatidx:
            sample = self._sample_arrays(events_rep, binning.names)
            self._flatidx[key] = translation.sanitized_flat_indices(
                sample, binning
            )
            self._flatidx_names[key] = tuple(binning.names)
        return self._flatidx[key]

    def cached_hist_matrix(self, binning, events_rep="events"):
        """Dense one-hot ``(n_events, binning.size)`` bin-membership matrix
        (out-of-range events get an all-zero row), cached like
        :meth:`cached_flat_indices`, so the histogram is one matmul
        (:func:`translation.histogram_matmul`). None when the matrix would
        exceed the size budget; callers then scatter-add."""
        size = binning.size
        key = (_rep_hash(events_rep), _rep_hash(binning), "hist_matrix")
        if key not in self._flatidx:
            idx = self.cached_flat_indices(binning, events_rep)
            if (
                size > _HIST_MATRIX_MAX_BINS
                or idx.shape[0] * size > _HIST_MATRIX_MAX_ELEMS
            ):
                return None
            matrix = torch.nn.functional.one_hot(idx, size + 1)[:, :size]
            self._flatidx[key] = matrix.to(TORCH_FTYPE)
            self._flatidx_names[key] = tuple(binning.names)
        return self._flatidx[key]

    def _array_to_binned(self, values, src_rep, dest_binning, averaged=True):
        idx = self.cached_flat_indices(dest_binning, src_rep)
        return translation.histogram(
            None, values, dest_binning, averaged=averaged, idx=idx
        )

    def get_keep_mask(self, cut_expression):
        """Boolean mask (a tensor on the container's device) of a cut
        expression over the variables and aux data in the current
        representation, e.g. ``"(pid >= -3) & (true_energy > 1)"``
        (``pisa_tpu/core/container.py:440``; reference
        ``container.py:1014``): evaluated on the tensors, in a namespace of
        them and ``np``; only the keys the expression names are read."""
        used = set(re.findall(r"[A-Za-z_]\w*", cut_expression))
        names = {key: self[key] for key in self.all_keys_incl_aux_data
                 if key in used}
        names["np"] = np
        mask = eval(  # noqa: S307 - namespace restricted to event arrays
            cut_expression, {"__builtins__": {}}, names
        )
        return torch.as_tensor(mask, device=self.device).to(torch.bool)

    def keep(self, keep_mask):
        """Keep the events where `keep_mask` (host or on the container's
        device) is true in every variable valid in the events
        representation, which becomes their only valid one; the cached
        indices built on the events are dropped."""
        if self.is_map:
            raise ValueError("Cannot apply event mask in binned representation")
        if self.shard is not None:
            raise NotImplementedError(
                f"Container {self.name!r} holds one rank's slice of a sharded"
                " template's events; a mask would change the slice")
        h = _rep_hash(self._representation)
        mask = torch.as_tensor(keep_mask, device=self.device).to(torch.bool)
        for key, per_rep in self._data.items():
            if h in per_rep and self.validity[key].get(h, False):
                values = per_rep[h]
                per_rep[h] = (values[:, mask] if key in self._laned
                              else values[mask])
                self.validity[key] = {h: True}
        self.drop_index_caches(set(self._data))

    # -- outputs --------------------------------------------------------------
    def get_hist(self, key):
        """(host ndarray reshaped to the binning's shape, binning)."""
        if not self.is_map:
            raise ValueError("Cannot retrieve hists from non-map data")
        data = self[key].detach().cpu().numpy()
        binning = self._representation
        if data.ndim > 1:
            return data.reshape(tuple(binning.shape) + (-1,)), binning
        return data.reshape(binning.shape), binning

    def get_map(self, key, error=None):
        hist, binning = self.get_hist(key)
        error_hist = None
        if error is not None:
            error_hist = np.abs(self.get_hist(error)[0])
        return Map(
            name=self.name, hist=hist, error_hist=error_hist, binning=binning
        )

    def __str__(self):
        rep = f"binned{self._representation.shape}" if self.is_map else "events"
        return f"Container('{self.name}', rep={rep}, keys={self.all_keys})"

    __repr__ = __str__


class VirtualContainer:
    """Proxy over several linked, physically identical containers: reads come
    from the first, writes go to all (reference ``container.py:363``)."""

    def __init__(self, name, containers):
        self.name = name
        first = containers[0]
        for c in containers[1:]:
            if c.size != first.size:
                raise ValueError(
                    "Cannot link containers of different sizes:"
                    f" {c.name}({c.size}) vs {first.name}({first.size})"
                )
        self.containers = list(containers)
        for c in self.containers:
            c.linked = True

    def unlink(self):
        for c in self.containers:
            c.linked = False

    @property
    def representation(self):
        return self.containers[0].representation

    @representation.setter
    def representation(self, rep):
        for c in self.containers:
            c.representation = rep

    @property
    def is_map(self):
        return self.containers[0].is_map

    @property
    def lanes(self):
        return self.containers[0].lanes

    @property
    def size(self):
        return self.containers[0].size

    @property
    def shape(self):
        return self.containers[0].shape

    def __getitem__(self, key):
        return self.containers[0][key]

    def __setitem__(self, key, value):
        # uploaded once: the linked containers share one tensor, which is
        # how core/stacking.py recognises a value they have in common
        value = self.containers[0]._to_device(value)
        for c in self.containers:
            c[key] = value

    def set_aux_data(self, key, val):
        for c in self.containers:
            c.set_aux_data(key, val)

    def mark_changed(self, key):
        for c in self.containers:
            c.mark_changed(key)

    def mark_valid(self, key):
        for c in self.containers:
            c.mark_valid(key)

    def __contains__(self, key):
        return key in self.containers[0]

    def __str__(self):
        return f"VirtualContainer('{self.name}', {[c.name for c in self.containers]})"

    __repr__ = __str__


class ContainerSet:
    """Collection of containers (one per event category) shared by all
    stages of a pipeline, on one device (reference ``container.py:199``)."""

    def __init__(self, name, device="cuda", containers=()):
        self.name = name
        self.device = resolve_device(device)
        self.linked_containers = []
        self.containers = []
        self._glob_aux = {}
        for container in containers:
            self.add_container(container)

    def add_container(self, container):
        if container.name in self.names:
            raise ValueError(
                f"Container {container.name!r} already in set {self.names}"
            )
        if container.device != self.device:
            raise ValueError(
                f"Container {container.name!r} is on {container.device}, the"
                f" set on {self.device}"
            )
        self.containers.append(container)

    @property
    def names(self):
        return [c.name for c in self.containers]

    def __iter__(self):
        """Iterate linked (virtual) containers once plus unlinked ones."""
        if self.linked_containers:
            linked = {c.name for vc in self.linked_containers for c in vc.containers}
            return iter(
                list(self.linked_containers)
                + [c for c in self.containers if c.name not in linked]
            )
        return iter(self.containers)

    def __len__(self):
        return len(self.containers)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.containers[key]
        for c in self.containers:
            if c.name == key:
                return c
        if key in self._glob_aux:
            return self._glob_aux[key]
        raise KeyError(f"No container or global aux {key!r}; have {self.names}")

    def __setitem__(self, key, value):
        """Global auxiliary data shared by all stages (e.g. 'output_binning';
        reference ``container.py:323``)."""
        self._glob_aux[key] = value

    def get_shared_keys(self, rep_indep=True):
        """The keys (aux data included) every container has: in any
        representation if `rep_indep`, else valid in the current one."""
        keys = [set(c.all_keys_incl_aux_data if rep_indep
                    else c.keys_incl_aux_data) for c in self.containers]
        return tuple(sorted(set.intersection(*keys))) if keys else ()

    # -- representation -------------------------------------------------------
    @property
    def representation(self):
        hs = {_rep_hash(c.representation) for c in self.containers}
        if len(hs) == 1:
            return self.containers[0].representation
        raise ValueError("Containers have mixed representations")

    @representation.setter
    def representation(self, rep):
        for c in self.containers:
            c.representation = rep

    @property
    def is_map(self):
        return all(c.is_map for c in self.containers)

    @property
    def lanes(self):
        """The lanes of the evaluation in progress (None: one point)."""
        return self.containers[0].lanes if self.containers else None

    @lanes.setter
    def lanes(self, lanes):
        for c in self.containers:
            c.lanes = lanes

    # -- linking --------------------------------------------------------------
    def link_containers(self, key, names):
        """Link containers `names` under a VirtualContainer called `key`
        (reference ``container.py:279``)."""
        containers = [self[n] for n in names if n in self.names]
        if containers:
            self.linked_containers.append(VirtualContainer(key, containers))

    def unlink_containers(self):
        for vc in self.linked_containers:
            vc.unlink()
        self.linked_containers = []

    # -- state, for template evaluations --------------------------------------
    def state(self):
        """Every container's :meth:`Container.state`."""
        return [(c, c.state()) for c in self.containers]

    def set_state(self, state):
        """Unlink and install a :meth:`state` in every container."""
        self.unlink_containers()
        for c, c_state in state:
            c.set_state(c_state)

    # -- outputs --------------------------------------------------------------
    def get_mapset(self, key, error=None):
        """One host Map per container in the current (binned) representation
        (reference ``container.py:339``)."""
        return MapSet(
            [c.get_map(key, error=error) for c in self.containers],
            name=self.name,
        )

    def __str__(self):
        return f"ContainerSet('{self.name}', {self.names})"

    __repr__ = __str__
