"""
Apply hypersurface (discrete detector systematics) corrections
(counterpart of ``pisa_tpu/stages/discr_sys/hypersurfaces.py:90-240``;
reference ``pisa/stages/discr_sys/hypersurfaces.py:42``): per-bin scale
factors from :class:`pisa_tpu_torch.utils.hypersurface.Hypersurface`,
evaluated on the pipeline's device. On a category-stacked container
(``core/stacking.py``) the linked groups are evaluated together, one row
each, and a rows map spreads them over the categories. In an evaluation of
lanes the scales gain a leading lane axis.

Interpolated hypersurfaces and fit-uncertainty propagation are not ported
yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import ast
from collections.abc import Mapping

import numpy as np
import torch

from pisa_tpu_torch.core.binning import MultiDimBinning
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils import hypersurface as hs
from pisa_tpu_torch.utils.log import logging

__all__ = ["hypersurfaces"]


class hypersurfaces(Stage):  # noqa: N801
    """Parameters
    ----------
    fit_results_file : str
        the official data-release CSV prototype
        (``.../hyperplanes_*.csv.bz2``).
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
        if propagate_uncertainty or interpolated:
            raise NotImplementedError(
                "hypersurfaces propagate_uncertainty/interpolated is not"
                " ported yet (ROADMAP queue 1, item 10)"
            )
        self.fit_results_file = fit_results_file
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
            expected_params=tuple(self.hypersurface_param_names),
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

    supports_stacked = True

    def stacked_rate_defer_ok(self):
        # reweighting per bin keeps the rate-deferral contract; scales
        # looked up per event would depend on the parameters per event
        return isinstance(self.apply_mode, MultiDimBinning)

    def _group_rows(self, cat_names):
        """(group names, rows) for a stacked container: linked categories
        share one hypersurface evaluation (the stacked form of
        link_containers), the others take their own by name."""
        group_of = {}
        group_names = []
        for gname, members in self.links.items():
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

    def _compute_stacked(self, container, param_values):
        group_names, rows = self._group_rows(container.cat_names)
        for gname in group_names:
            if gname not in self.hypersurfaces:
                raise ValueError(f"no hypersurface for map {gname!r}")
        scales = hs.evaluate_stacked(
            [self.hypersurfaces[g] for g in group_names], param_values,
            container.device, self._stacked_coeffts, lanes=container.lanes,
        )
        # empty bins (non-finite fit) -> scale 1
        container.set_stacked(
            "hs_scales", torch.where(torch.isfinite(scales), scales, 1.0),
            rows=rows,
        )

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
        param_values = {
            name: self.params[name].value.magnitude
            for name in self.hypersurface_param_names
        }
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._compute_stacked(container, param_values)
                continue
            scales = self.hypersurfaces[container.name].evaluate(
                param_values, self.data.device, lanes=container.lanes
            )
            # empty bins (non-finite fit) -> scale 1
            container["hs_scales"] = torch.where(
                torch.isfinite(scales), scales, 1.0
            )
        self.data.unlink_containers()

    def apply_function(self):
        for container in self.data:
            if getattr(container, "is_stacked", False):
                # the (G, nbins) group scales per category: one gather
                scales = container.expanded("hs_scales")
            else:
                scales = container["hs_scales"]
            # update uncertainty first, before weights change
            if self.error_method == "sumw2":
                if self.data.representation == "events":
                    logging.trace(
                        "events mode: hypersurface error propagation ignored"
                    )
                else:
                    container["errors"] = container["errors"] * scales
                if "bin_unc2" in container.keys:
                    container["bin_unc2"] = torch.clamp(
                        container["bin_unc2"] * scales, min=0.0
                    )
            container["weights"] = torch.clamp(
                container["weights"] * scales, min=0.0
            )
