"""
Hypersurfaces from CSV files with linear interpolation across an
oscillation parameter (counterpart of
``pisa_tpu/stages/discr_sys/csv_hypersurfaces.py``; reference
``pisa/stages/discr_sys/csv_hypersurfaces.py``): each CSV holds one linear
hypersurface per bin *per value of the interpolation parameter* (e.g.
dm31); the stage interpolates the intercept and slopes linearly to the
parameter's value, then evaluates ``intercept + sum slope_p (p -
nominal_p)``.

The interpolation runs on the device: the bracketing grid values are found
by ``searchsorted``, so the interpolation parameter may be free in a
compiled template (and a captured ``value_and_grad``), with its gradient
through the interpolation weight. A host value outside the grid raises, as
in the JAX package; a traced value is not checked (it extends the nearest
interval linearly), so keep the parameter's range inside the grid. On a
category-stacked container (``core/stacking.py``) the linked groups are
evaluated together, one row each, as ``discr_sys.hypersurfaces`` does.
"""

from __future__ import annotations

import ast
import os
from collections.abc import Mapping

import numpy as np
import torch

from pisa_tpu_torch import FTYPE, TORCH_FTYPE, ureg
from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage, in_data_type
from pisa_tpu_torch.stages.discr_sys.hypersurfaces import group_rows
from pisa_tpu_torch.utils.fileio import read_csv
from pisa_tpu_torch.utils.log import logging

__all__ = ["csv_hypersurfaces", "init_test"]


class csv_hypersurfaces(Stage):  # noqa: N801
    """Parameters: fit_results_file(s), nominal_systematics (dict),
    inter_param (str), links, propagate_uncertainty.

    Each file ``[hs_]<name>.csv[.bz2]`` serves the container (or linked
    group) ``<name>``: columns ``intercept``, ``intercept_sigma``, one slope
    per systematic, the interpolation parameter, and the bin centers; for
    each value of the interpolation parameter one row per bin, in the
    binning's flat order."""

    def __init__(
        self,
        fit_results_file,
        nominal_systematics,
        inter_param,
        links=None,
        propagate_uncertainty=True,
        **std_kwargs,
    ):
        if isinstance(fit_results_file, str):
            fit_results_file = [
                s.strip() for s in fit_results_file.split(",")
            ]
        self.fit_results_file = fit_results_file
        if isinstance(nominal_systematics, str):
            nominal_systematics = ast.literal_eval(nominal_systematics)
        self.nominal_systematics = dict(nominal_systematics)
        self.inter_param = inter_param
        self.propagate_uncertainty = propagate_uncertainty
        self.hs = {}

        expected_container_keys = ["weights"]
        if std_kwargs.get("error_method"):
            expected_container_keys.append("errors")

        super().__init__(
            expected_params=tuple(
                list(self.nominal_systematics.keys()) + [inter_param]
            ),
            expected_container_keys=tuple(expected_container_keys),
            **std_kwargs,
        )
        if links is None:
            self.links = {}
        elif isinstance(links, Mapping):
            self.links = dict(links)
        else:
            self.links = ast.literal_eval(links)
        #: per group: the sorted grid values (n,), the coefficients
        #: (n, 1 + P, size) of intercept and slopes, the uncertainty (size,)
        self._grid = {}
        self._coeffts = {}
        self._uncertainty = {}
        #: device tensors, uploaded once: per (group names, device)
        self._device = {}

    supports_stacked = True

    def stacked_rate_defer_ok(self):
        # reweighting per bin keeps the rate-deferral contract
        return isinstance(self.apply_mode, MultiDimBinning)

    def setup_function(self):
        self.hs = {}
        for f in self.fit_results_file:
            k = os.path.splitext(os.path.basename(f))[0]
            if k.endswith(".csv"):  # e.g. .csv.bz2 double extension
                k = os.path.splitext(k)[0]
            if k.startswith("hs_"):
                k = k[3:]
            if k in self.hs:
                raise ValueError(f"{k} already exists in the HS dict")
            self.hs[k] = read_csv(f)

        for key, val in self.links.items():
            self.data.link_containers(key, val)
        columns = ["intercept"] + list(self.nominal_systematics)
        val = self.params[self.inter_param].value.magnitude
        for container in self.data:
            if container.name not in self.hs:
                raise ValueError(
                    f"no hypersurface for {container.name!r}; have"
                    f" {list(self.hs)}"
                )
            table = self.hs[container.name]
            grid = table[self.inter_param]
            uniq = np.unique(grid)
            self._grid[container.name] = uniq
            self._coeffts[container.name] = np.stack([
                np.stack([table[col][grid == value] for col in columns])
                .reshape(len(columns), container.size)
                for value in uniq
            ])
            if self.propagate_uncertainty:
                # the intercept's sigma at the grid value nearest the
                # set-up value (reference csv_hypersurfaces.py)
                start = int(np.argmin(np.abs(grid - float(val))))
                _, counts = np.unique(grid, return_counts=True)
                stop = start + counts[0]
                self._uncertainty[container.name] = (
                    table["intercept_sigma"][start:stop]
                    .reshape(container.size).astype(FTYPE)
                )
        self.data.unlink_containers()
        self._device = {}

    def _on_device(self, names, device):
        """(grid (n,) float64, coefficients (G, n, 1 + P, size), the bins
        whose coefficients are not finite (G, n, size) or None, uncertainty
        (G, size) or None) of the groups `names` on `device`. Coefficients
        that are not finite are uploaded as the identity surface (intercept
        1, slopes 0), so that the gradient stays finite; their bins' scale
        is 1, as the JAX package's NaN scale becomes."""
        key = (tuple(names), device)
        if key not in self._device:
            grids = [self._grid[n] for n in names]
            if any(not np.array_equal(g, grids[0]) for g in grids[1:]):
                raise ValueError(
                    f"{self.inter_param} grids differ between the"
                    f" hypersurfaces of {names}")
            coeffts = np.stack([self._coeffts[n] for n in names])
            bad = ~np.isfinite(coeffts).all(axis=2)  # (G, n, size)
            identity = np.zeros(coeffts.shape[2])
            identity[0] = 1.0
            coeffts = np.where(bad[:, :, None, :], identity[:, None],
                               coeffts)
            unc = None
            if self.propagate_uncertainty:
                unc = torch.as_tensor(
                    np.stack([self._uncertainty[n] for n in names]),
                    dtype=TORCH_FTYPE, device=device)
            self._device[key] = (
                torch.as_tensor(grids[0], dtype=torch.float64,
                                device=device),
                torch.as_tensor(coeffts, dtype=TORCH_FTYPE, device=device),
                torch.as_tensor(bad, device=device) if bad.any() else None,
                unc,
            )
        return self._device[key]

    def _scales(self, names, device, lanes):
        """The groups' scales, (G, size) or with `lanes` (lanes, G, size),
        and their uncertainties (G, size) or None."""
        grid, coeffts, bad, unc = self._on_device(names, device)
        x = self.params[self.inter_param].value.magnitude
        if not isinstance(x, torch.Tensor):
            x = float(np.asarray(x))
            host_grid = self._grid[names[0]]
            if not host_grid[0] <= x <= host_grid[-1]:
                raise ValueError(
                    f"{self.inter_param} = {x} outside interpolation range"
                )
            x = torch.full((), x, dtype=torch.float64, device=device)
        lead = () if lanes is None else (lanes,)
        x = x.to(torch.float64).reshape(-1).expand(lead or (1,))
        if grid.numel() == 1:
            c = coeffts[:, 0].expand(x.shape + coeffts[:, 0].shape)
            if bad is not None:
                bad = bad[:, 0].expand(x.shape + bad[:, 0].shape)
        else:
            # the interval [grid[i], grid[i + 1]] that holds x
            i = torch.clamp(
                torch.searchsorted(grid, x.detach(), right=True) - 1,
                0, grid.numel() - 2)
            lo, hi = grid[i], grid[i + 1]
            frac = in_data_type((x - lo) / (hi - lo))[:, None, None, None]
            c_lo = coeffts.index_select(1, i).movedim(1, 0)
            c_hi = coeffts.index_select(1, i + 1).movedim(1, 0)
            c = c_lo + frac * (c_hi - c_lo)  # (L, G, 1 + P, size)
            if bad is not None:
                bad = (bad.index_select(1, i) | bad.index_select(1, i + 1)
                       ).movedim(1, 0)  # (L, G, size)
        scales = c[:, :, 0]
        for k, name in enumerate(self.nominal_systematics, start=1):
            p = in_data_type(self.params[name].value.magnitude)
            if isinstance(p, torch.Tensor):
                p = p.reshape(-1)[:, None, None]
            scales = scales + c[:, :, k] * (
                p - self.nominal_systematics[name])
        if lanes is None:
            scales = scales[0]
        keep = torch.isfinite(scales)
        if bad is not None:
            keep = keep & ~(bad if lanes is not None else bad[0])
        return torch.where(keep, scales, 1.0), unc

    def compute_function(self):
        for key, val in self.links.items():
            self.data.link_containers(key, val)
        for container in self.data:
            if getattr(container, "is_stacked", False):
                names, rows = group_rows(self.links, container.cat_names)
                scales, unc = self._scales(names, container.device,
                                           container.lanes)
                container.set_stacked("hs_scales", scales, rows=rows)
                if unc is not None:
                    container.set_stacked("hs_scales_uncertainty", unc,
                                          rows=rows)
                continue
            scales, unc = self._scales([container.name], self.data.device,
                                       container.lanes)
            container["hs_scales"] = scales[..., 0, :]
            if unc is not None:
                container["hs_scales_uncertainty"] = unc[0]
        self.data.unlink_containers()

    def apply_function(self):
        for container in self.data:
            stacked = getattr(container, "is_stacked", False)
            # a stacked container's (G, nbins) group values per category:
            # one gather
            get = container.expanded if stacked else container.__getitem__
            scales = get("hs_scales")
            if self.error_method == "sumw2":
                if self.data.representation == "events":
                    logging.warning(
                        "events mode: hypersurface error propagation ignored"
                    )
                elif self.propagate_uncertainty:
                    container["errors"] = (container["weights"]
                                           * get("hs_scales_uncertainty"))
                else:
                    container["errors"] = container["errors"] * scales
                if "bin_unc2" in container.keys:
                    container["bin_unc2"] = torch.clamp(
                        container["bin_unc2"] * scales, min=0.0)
            container["weights"] = torch.clamp(container["weights"] * scales,
                                               min=0.0)


def init_test(**param_kwargs):
    """Instantiation example (the JAX package's, on the repo's
    ``events/hs_test.csv``)."""
    from pisa_tpu_torch.core.binning import OneDimBinning

    param_kwargs.pop("range", None)
    param_set = ParamSet(
        [
            Param(name="dom_eff", value=1.0, **param_kwargs),
            Param(name="hole_ice_p0", value=0.1, **param_kwargs),
            Param(name="hole_ice_p1", value=-0.05, **param_kwargs),
            Param(name="bulk_ice_scatter", value=1.05, **param_kwargs),
            Param(name="bulk_ice_abs", value=1.0, **param_kwargs),
            Param(
                name="dm31", value=3e-3 * ureg.eV**2,
                range=[1e-3, 7e-3] * ureg.eV**2, **param_kwargs,
            ),
        ]
    )
    nominal = {
        "dom_eff": 1.00, "hole_ice_p0": 0.10, "hole_ice_p1": -0.05,
        "bulk_ice_abs": 1.00, "bulk_ice_scatter": 1.00,
    }
    dd_en = OneDimBinning(
        "reco_energy", is_log=True,
        bin_edges=[
            6.31, 8.46, 11.34, 15.20, 20.38, 27.31, 36.61, 49.08, 65.79,
            88.20, 158.49,
        ] * ureg.GeV,
    )
    dd_cz = OneDimBinning(
        "reco_coszen", num_bins=10, is_lin=True, domain=[-1, 0.1]
    )
    dd_pid = OneDimBinning("pid", bin_edges=[0.55, 0.75, 1.0])
    binning = MultiDimBinning(
        [dd_en, dd_cz, dd_pid], name="oscNext_verification"
    )
    return csv_hypersurfaces(
        fit_results_file="events/hs_test.csv",
        nominal_systematics=nominal,
        inter_param="dm31",
        links={"test": ["nutau_cc", "numubar_nc"]},
        params=param_set,
        calc_mode=binning,
        apply_mode=binning,
    )
