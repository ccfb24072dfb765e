"""
Apply hypersurface (discrete detector systematics) corrections
(counterpart of ``pisa_tpu/stages/discr_sys/hypersurfaces.py``; reference
``pisa/stages/discr_sys/hypersurfaces.py:42``): per-bin scale factors from
:class:`pisa_tpu_torch.utils.hypersurface.Hypersurface`, evaluated on the
pipeline's device, optionally with the fit's uncertainty propagated into
'errors'. On a category-stacked container (``core/stacking.py``) the linked
groups are evaluated together, one row each, and a rows map spreads them
over the categories. In an evaluation of lanes the scales gain a leading
lane axis.

Interpolated hypersurfaces (``interpolated = True``) are interpolated to the
interpolation params' values on the host, as in the JAX package; the
surfaces at the last point are kept (and their coefficients uploaded once),
so a compiled template with those params fixed reads nothing on the host.
With one of them free a compiled template's evaluation raises TypeError, as
the JAX package's trace does (``csv_hypersurfaces`` interpolates on the
device instead).
"""

from __future__ import annotations

import ast
from collections.abc import Mapping

import numpy as np
import torch

from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.param import Param, ParamSet
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils import hypersurface as hs
from pisa_tpu_torch.utils.log import logging

__all__ = ["hypersurfaces", "group_rows", "init_test"]


def group_rows(links, cat_names):
    """(group names, rows) for a stacked container: the categories that
    `links` (merged name -> member names) joins share one row (the stacked
    form of link_containers), the others take their own by name."""
    group_of = {}
    group_names = []
    for gname, members in links.items():
        group_of.update(
            {m: len(group_names) for m in members if m in cat_names}
        )
        group_names.append(gname)
    rows = []
    for name in cat_names:
        if name not in group_of:
            group_of[name] = len(group_names)
            group_names.append(name)
        rows.append(group_of[name])
    return group_names, np.asarray(rows, dtype=np.int32)


class hypersurfaces(Stage):  # noqa: N801
    """Parameters
    ----------
    fit_results_file : str
        JSON fit results (``utils.hypersurface.save_hypersurfaces``), or
        with `interpolated` the assembled interpolated fits, or the official
        data-release CSV prototype (``.../hyperplanes_*.csv.bz2``).
    propagate_uncertainty : bool
        propagate the hypersurface fit's uncertainty into 'errors'.
    interpolated : bool
        interpolate the fits over their interpolation params.
    links : dict or str
        merged-container name -> list of container names.
    """

    def __init__(
        self,
        fit_results_file,
        propagate_uncertainty=False,
        interpolated=False,
        links=None,
        **std_kwargs,
    ):
        self.fit_results_file = fit_results_file
        self.propagate_uncertainty = propagate_uncertainty
        self.interpolated = interpolated
        self.inter_params = []
        if interpolated:
            self.hypersurfaces = hs.load_interpolated_hypersurfaces(
                fit_results_file, expected_binning=std_kwargs.get("calc_mode")
            )
            self.inter_params = list(
                self.hypersurfaces.values()
            )[0].interpolation_param_names
        else:
            self.hypersurfaces = hs.load_hypersurfaces(
                fit_results_file, expected_binning=std_kwargs.get("calc_mode")
            )
        self.hypersurface_param_names = list(
            self.hypersurfaces.values()
        )[0].param_names

        expected_container_keys = ["weights"]
        if std_kwargs.get("error_method"):
            expected_container_keys.append("errors")
        super().__init__(
            expected_params=tuple(
                self.hypersurface_param_names + self.inter_params
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
        self._stacked_coeffts = {}  # utils.hypersurface.evaluate_stacked's
        #: the interpolation point of `_surfaces`'s surfaces, and those
        self._interp_point = None
        self._interp_surfaces = None

    supports_stacked = True
    # on the output binning, after the histogram's sum over the ranks
    supports_shard = True

    def stacked_rate_defer_ok(self):
        # reweighting per bin keeps the rate-deferral contract; scales
        # looked up per event would depend on the parameters per event
        return isinstance(self.apply_mode, MultiDimBinning)

    def _surfaces(self):
        """{map name: Hypersurface} at the current parameter values: the
        loaded ones, or the interpolated ones at the interpolation params'
        values (kept while the point stays the same)."""
        if not self.interpolated:
            return self.hypersurfaces
        point = {}
        for name in self.inter_params:
            value = self.params[name].value.magnitude
            if isinstance(value, torch.Tensor):
                raise TypeError(
                    f"interpolated hypersurfaces read {name!r} on the host;"
                    " a compiled template cannot take it free (fix it, or"
                    " use discr_sys.csv_hypersurfaces)"
                )
            point[name] = float(np.asarray(value))
        key = tuple(point.values())
        if key != self._interp_point:
            self._interp_surfaces = {
                name: interp.get_hypersurface(**point)
                for name, interp in self.hypersurfaces.items()
            }
            self._interp_point = key
            self._stacked_coeffts.clear()
        return self._interp_surfaces

    def _compute_stacked(self, container, surfaces, param_values):
        group_names, rows = group_rows(self.links, container.cat_names)
        for gname in group_names:
            if gname not in surfaces:
                raise ValueError(f"no hypersurface for map {gname!r}")
        out = hs.evaluate_stacked(
            [surfaces[g] for g in group_names], param_values,
            container.device, self._stacked_coeffts, lanes=container.lanes,
            return_uncertainty=self.propagate_uncertainty,
        )
        scales = out[0] if self.propagate_uncertainty else out
        finite = torch.isfinite(scales)
        # empty bins (non-finite fit) -> scale 1, uncertainty 0
        container.set_stacked("hs_scales", torch.where(finite, scales, 1.0),
                              rows=rows)
        if self.propagate_uncertainty:
            container.set_stacked("hs_scales_uncertainty",
                                  torch.where(finite, out[1], 0.0), rows=rows)

    def setup_function(self):
        for key, val in self.links.items():
            self.data.link_containers(key, val)
        for container in self.data:
            if container.name not in self.hypersurfaces:
                raise ValueError(f"no hypersurface for map {container.name!r}")
        self.data.unlink_containers()

    def compute_function(self):
        for key, val in self.links.items():
            self.data.link_containers(key, val)
        surfaces = self._surfaces()
        param_values = {
            name: self.params[name].value.magnitude
            for name in self.hypersurface_param_names
        }
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._compute_stacked(container, surfaces, param_values)
                continue
            out = surfaces[container.name].evaluate(
                param_values, return_uncertainty=self.propagate_uncertainty,
                device=self.data.device, lanes=container.lanes,
            )
            scales = out[0] if self.propagate_uncertainty else out
            finite = torch.isfinite(scales)
            if self.propagate_uncertainty:
                container["hs_scales_uncertainty"] = torch.where(
                    finite, out[1], 0.0)
            # empty bins (non-finite fit) -> scale 1
            container["hs_scales"] = torch.where(finite, scales, 1.0)
        self.data.unlink_containers()

    def apply_function(self):
        for container in self.data:
            stacked = getattr(container, "is_stacked", False)
            # a stacked container's (G, nbins) group values per category:
            # one gather
            get = container.expanded if stacked else container.__getitem__
            scales = get("hs_scales")
            # update uncertainty first, before weights change
            if self.error_method == "sumw2":
                if self.data.representation == "events":
                    logging.trace(
                        "events mode: hypersurface error propagation ignored"
                    )
                elif self.propagate_uncertainty:
                    container["errors"] = (container["weights"]
                                           * get("hs_scales_uncertainty"))
                else:
                    container["errors"] = container["errors"] * scales
                if "bin_unc2" in container.keys:
                    container["bin_unc2"] = torch.clamp(
                        container["bin_unc2"] * scales, min=0.0
                    )
            container["weights"] = torch.clamp(
                container["weights"] * scales, min=0.0
            )


def init_test(**param_kwargs):
    """Instantiation example (the JAX package's: the data release's
    hyperplanes)."""
    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.binning import OneDimBinning

    param_set = ParamSet(
        [
            Param(name="opt_eff_overall", value=1.0, **param_kwargs),
            Param(name="opt_eff_lateral", value=25, **param_kwargs),
            Param(name="opt_eff_headon", value=0.0, **param_kwargs),
            Param(name="ice_scattering", value=0.0, **param_kwargs),
            Param(name="ice_absorption", value=0.0, **param_kwargs),
        ]
    )
    dd_en = OneDimBinning(
        "reco_energy",
        is_log=True,
        bin_edges=[
            5.62341325, 7.49894209, 10.0, 13.33521432, 17.7827941,
            23.71373706, 31.6227766, 42.16965034, 56.23413252,
        ] * ureg.GeV,
    )
    dd_cz = OneDimBinning(
        "reco_coszen", num_bins=8, is_lin=True, domain=[-1, 1]
    )
    dd_pid = OneDimBinning("pid", bin_edges=[-0.5, 0.5, 1.5])
    return hypersurfaces(
        params=param_set,
        fit_results_file="events/IceCube_3y_oscillations/hyperplanes_*.csv.bz2",
        error_method="sumw2",
        calc_mode=MultiDimBinning(
            [dd_en, dd_cz, dd_pid], name="dragon_datarelease"
        ),
        # links matching the harness's containers
        links={
            "nutau_cc+nutaubar_cc": ["nutau_cc"],
            "nu_nc+nubar_nc": ["numubar_nc"],
        },
    )
