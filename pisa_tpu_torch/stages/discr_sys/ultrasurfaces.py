"""
Ultrasurfaces: per-EVENT detector-systematics gradients (counterpart of
``pisa_tpu/stages/discr_sys/ultrasurfaces.py``; reference
``pisa/stages/discr_sys/ultrasurfaces.py``): gradients fitted per MC event
are matched to the pipeline's events by nearest neighbour in a chosen
variable space at set-up (``scipy.spatial.cKDTree``, k = 1, Euclidean, on
the host: the JAX package's sklearn ``KDTree`` query); the per-event
reweight is ``exp(sum_g grad_g * feature_g(delta p))``, whose features are
polynomial terms encoded in the gradient names (``grad__p1__p2`` ->
(delta p1)(delta p2)), with optional support bounds and extrapolation.

The table is read with pandas: ``.feather`` needs pyarrow as well,
``.csv`` only pandas. The compute is torch, differentiable in the params.
"""

from __future__ import annotations

import ast
import collections.abc
import os
import tempfile

import numpy as np
import torch

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.utils.log import logging
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["ultrasurfaces", "init_test", "nearest_neighbours"]


def _parse_gradient_params(gradient_name):
    """Parameter names from a gradient column name: 'grad__p1__p2' ->
    ['p1', 'p2']; 'grad_p' -> ['p']."""
    body = gradient_name[len("grad"):]
    if "__" in body:
        return [p for p in body.split("__") if p]
    return [body.lstrip("_")] if body.lstrip("_") else []


def _read_table(path):
    """The gradient table as a pandas DataFrame (feather or CSV)."""
    import pandas as pd

    if path.endswith(".feather"):
        try:
            import pyarrow  # noqa: F401
        except ImportError as exc:
            raise ImportError(
                f"reading {path} needs pyarrow (feather); write the table"
                " as .csv instead") from exc
        return pd.read_feather(path)
    return pd.read_csv(path)


def nearest_neighbours(points, queries):
    """(distances, indices) of each query's nearest point (k = 1,
    Euclidean), both (n_queries,)."""
    from scipy.spatial import cKDTree

    return cKDTree(points).query(queries, k=1)


class ultrasurfaces(Stage):  # noqa: N801
    """Parameters: fit_results_file (feather/csv of per-event gradients),
    nominal_points (dict), varnames, event_grouping_key, approx_exponential,
    support, extrapolation, distance_tol."""

    def __init__(
        self,
        fit_results_file,
        nominal_points,
        varnames=(
            "pid", "true_coszen", "reco_coszen", "true_energy",
            "reco_energy",
        ),
        event_grouping_key="event_category",
        approx_exponential=False,
        support=None,
        extrapolation="continue",
        distance_tol=0,
        **std_kwargs,
    ):
        self.fit_results_file = find_resource(fit_results_file)
        self.varnames = list(varnames)
        self.event_grouping_key = event_grouping_key
        self.approx_exponential = approx_exponential
        self.distance_tol = float(distance_tol)
        if isinstance(nominal_points, str):
            nominal_points = ast.literal_eval(nominal_points)
        self.nominal_points = dict(nominal_points)
        if isinstance(support, str):
            support = ast.literal_eval(support)
        if support is not None and not isinstance(
            support, collections.abc.Mapping
        ):
            raise ValueError("unknown format for support")
        self.support = support
        if extrapolation not in ("continue", "linear", "constant"):
            raise ValueError(f"unknown extrapolation {extrapolation!r}")
        self.extrapolation = extrapolation

        expected_keys = list(self.varnames) + ["weights"]
        if "true_energy" not in expected_keys:
            expected_keys.append("true_energy")

        super().__init__(
            expected_params=tuple(self.nominal_points.keys()),
            expected_container_keys=tuple(expected_keys),
            **std_kwargs,
        )
        self.gradient_names = None
        #: per container name, the matched table rows (for diagnostics)
        self.matched_indices = {}

    def setup_function(self):
        df = _read_table(self.fit_results_file)
        self.gradient_names = [k for k in df.keys() if k.startswith("grad")]
        x_df = df[self.varnames].to_numpy()

        groupings_array = None
        if self.event_grouping_key is not None and (
            self.event_grouping_key in df
        ):
            groupings_array = df[self.event_grouping_key].to_numpy()

        for container in self.data:
            n = container.size
            x_pisa = np.zeros((n, len(self.varnames)), dtype=x_df.dtype)
            for i, vname in enumerate(self.varnames):
                x_pisa[:, i] = container[vname].cpu().numpy()

            if groupings_array is not None:
                # restrict matching to this container's event grouping
                matches = [
                    g for g in set(groupings_array)
                    if str(g) in container.name or container.name in str(g)
                ]
                if len(matches) != 1:
                    raise ValueError(
                        f"cannot associate container {container.name!r} to"
                        f" an event grouping among {set(groupings_array)}"
                    )
                where = np.where(groupings_array == matches[0])[0]
                dists, ind = nearest_neighbours(x_df[where], x_pisa)
                ind = where[ind]
            else:
                dists, ind = nearest_neighbours(x_df, x_pisa)
            self.matched_indices[container.name] = ind

            n_out = int(np.sum(dists > self.distance_tol))
            if n_out:
                logging.warning(
                    "%d %s events matched beyond tolerance %.2g (max dist"
                    " %.2g)",
                    n_out, container.name, self.distance_tol,
                    float(np.max(dists)),
                )
            for gname in self.gradient_names:
                container[gname] = df[gname].to_numpy()[ind].astype(FTYPE)
            container["us_scales"] = np.ones(n, dtype=FTYPE)

    def _feature(self, gradient_name):
        """Polynomial feature of the parameter shifts for one gradient."""
        param_names = _parse_gradient_params(gradient_name)
        grad_order = len(param_names)
        has_interactions = len(set(param_names)) > 1
        feature = 1.0
        for i, pname in enumerate(param_names):
            raw = in_data_type(self.params[pname].value.magnitude)
            if self.support is None:
                bounded = raw
            else:
                lo, hi = self.support[pname]
                bounded = (torch.clamp(raw, lo, hi)
                           if isinstance(raw, torch.Tensor)
                           else min(max(raw, lo), hi))
            x = raw - self.nominal_points[pname]
            x_b = bounded - self.nominal_points[pname]

            if self.extrapolation == "continue":
                feature = feature * x
            elif self.extrapolation == "constant":
                feature = feature * x_b
            else:  # linear
                if grad_order == 1:
                    feature = feature * x
                    continue
                if has_interactions:
                    raise RuntimeError(
                        "linear extrapolation undefined for interaction"
                        f" gradients: {gradient_name}"
                    )
                if i == 0:
                    feature = feature * x_b
                elif i == 1:
                    feature = feature * (2 * x - x_b)
                else:
                    raise RuntimeError(
                        "linear extrapolation only for orders <= 2"
                    )
        return feature

    def compute_function(self):
        features = {g: self._feature(g) for g in self.gradient_names}
        for container in self.data:
            shifts = 0.0
            for gname in self.gradient_names:
                shifts = shifts + container[gname] * features[gname]
            if self.approx_exponential:
                container["us_scales"] = 1.0 + shifts
            else:
                container["us_scales"] = torch.exp(shifts)

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["us_scales"]
            )


def init_test(**param_kwargs):
    """Instantiation example: the JAX package's synthetic gradient table,
    written as CSV (so that pyarrow is not needed) into the temporary
    directory."""
    import pandas as pd

    from pisa_tpu_torch.core.param import Param, ParamSet

    p1, p2 = "opt_eff_overall", "ice_scattering"
    param_set = ParamSet(
        [
            Param(name=p1, value=1.0, **param_kwargs),
            Param(name=p2, value=0.0, **param_kwargs),
        ]
    )
    nominal_points = {p1: 1.0, p2: 0.0}

    rng = np.random.RandomState(0)
    n = 100
    varnames = ["true_energy", "true_coszen"]
    df = {
        "true_energy": (10 ** rng.uniform(0.1, 1.9, n)).astype(FTYPE),
        "true_coszen": rng.uniform(-1, 1, n).astype(FTYPE),
    }
    df[f"grad__{p1}"] = rng.uniform(0, 2, n).astype(FTYPE)
    df[f"grad__{p2}"] = rng.uniform(0, 2, n).astype(FTYPE)
    df[f"grad__{p1}__{p2}"] = rng.uniform(0, 2, n).astype(FTYPE)
    path = os.path.join(tempfile.gettempdir(),
                        f"pisa_tpu_torch_test_us_file_{os.getpid()}.csv")
    pd.DataFrame.from_dict(df).to_csv(path, index=False)

    return ultrasurfaces(
        params=param_set,
        fit_results_file=path,
        varnames=varnames,
        nominal_points=nominal_points,
        calc_mode="events",
        event_grouping_key=None,
    )
