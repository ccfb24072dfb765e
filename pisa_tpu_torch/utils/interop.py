"""
State carried across from the JAX package, as plain numpy and python
values, so that both packages compute from identical inputs. Nothing here
imports ``jax`` or ``pisa_tpu``: callers pass the JAX package's values in.

- :func:`set_param_values` sets the port's params from
  ``{name: (magnitude, unit_str)}`` (read off a ``pisa_tpu`` ParamSet);
- :func:`chain_inputs_from_jax` turns the JAX package's ``(1, 57)`` pack and
  its ``(L, rows, 128)``-blocked kernel geometry
  (``pisa_tpu/ops/osc/pallas_chain.py:prepare_chain_geometry``) into the
  port's ``(57,)`` pack and ``(L, N)`` layer-major slabs;
- :func:`template_inputs_from_jax` puts the JAX template's rescaled vector
  and bounds (ordered by its ``free_names``) into the order of the port's
  ``CompiledTemplate``, and :func:`to_template_order` does so for any
  per-free-param vector (e.g. a gradient).
"""

from __future__ import annotations

import numpy as np
import torch

from pisa_tpu_torch.ops.osc.chain import tile_table
from pisa_tpu_torch.units import Quantity

__all__ = [
    "set_param_values",
    "chain_inputs_from_jax",
    "template_inputs_from_jax",
    "to_template_order",
]


def set_param_values(pipeline, values):
    """Set each named param of `pipeline` (a port Pipeline) to
    ``Quantity(magnitude, unit_str)``; `values` is
    ``{name: (magnitude, unit_str)}``."""
    params = pipeline.params
    for name, (magnitude, units) in values.items():
        params[name].value = Quantity(magnitude, units)


def chain_inputs_from_jax(pvec, geom, n, *, device="cpu"):
    """The JAX package's packed parameters and blocked, sorted geometry ->
    the port's ``(pvec, geom)`` for :func:`pisa_tpu_torch.ops.osc.chain.
    osc_probs_prepared`.

    Parameters
    ----------
    pvec : (1, 57) array
    geom : dict of arrays from the JAX ``prepare_chain_geometry``: ``e2``
        (rows, 128), ``dens``/``dist`` (L, rows, 128), optionally
        ``order``/``inv`` (N,)
    n : int
        the original (pre-padding) point count

    The blocking and padding are undone; the per-point loop bound ``nl`` is
    1 + the index of each point's last nonzero-length layer, and ``tiles``
    is the port's tile table of the points in that order. Tensors take the
    dtype of `geom['e2']`.
    """
    e2 = np.asarray(geom["e2"])
    dtype = torch.float64 if e2.dtype == np.float64 else torch.float32
    n_layers = np.asarray(geom["dens"]).shape[0]
    e = e2.reshape(-1)[:n]
    dens = np.asarray(geom["dens"]).reshape(n_layers, -1)[:, :n]
    dist = np.asarray(geom["dist"]).reshape(n_layers, -1)[:, :n]
    real = dist > 0.0
    nl = np.where(
        real.any(axis=0), n_layers - np.argmax(real[::-1], axis=0), 0
    )

    def put(x, dt):
        return torch.as_tensor(np.array(x, order="C"), dtype=dt, device=device)

    out = {
        "e": put(e, dtype),
        "dens": put(dens, dtype),
        "dist": put(dist, dtype),
        "nl": put(nl, torch.int32),
        "tiles": tile_table(dens.T, dist.T, dtype=dtype, device=device),
    }
    if "order" in geom:
        out["order"] = put(np.asarray(geom["order"]), torch.int64)
        out["inv"] = put(np.asarray(geom["inv"]), torch.int64)
    else:
        out["inv"] = put(np.arange(n), torch.int64)
    return put(np.asarray(pvec).reshape(-1), dtype), out


def to_template_order(template, free_names, values):
    """`values` (one per name of `free_names`, the JAX template's order) as
    a float64 numpy vector in the order of ``template.free_names`` (a port
    ``CompiledTemplate``); the two must free the same params."""
    if sorted(free_names) != sorted(template.free_names):
        raise ValueError(
            f"free params differ: {sorted(free_names)} vs"
            f" {sorted(template.free_names)}"
        )
    values = np.asarray(values, dtype=np.float64)
    index = {name: i for i, name in enumerate(free_names)}
    return np.asarray([values[index[n]] for n in template.free_names])


def template_inputs_from_jax(template, free_names, rescaled, los, his):
    """The JAX template's ``free_names``, rescaled vector and bounds (from
    its ``_current_bounds()``) -> ``(vec, los, his)`` as float64 numpy in
    the port template's order."""
    return tuple(
        to_template_order(template, free_names, v) for v in (rescaled, los, his)
    )
