"""
GENIE charm-production inelasticity correction (counterpart of
``pisa_tpu/stages/xsec/correct_charm_y.py``; reference
``pisa/stages/xsec/correct_charm_y.py``; MC testing only): reweights CC
events by a precomputed 2-D (log10 E, Bjorken y) correction histogram,
split by upgoing/other coszen and nu/nubar. The lookup runs on the host at
set-up; an apply is one product on the containers' device.
"""

from __future__ import annotations

import pickle

import numpy as np

from pisa_tpu_torch import FTYPE
from pisa_tpu_torch.core.stage import Stage
from pisa_tpu_torch.utils.resources import find_resource

__all__ = ["correct_charm_y", "init_test"]


def _host(tensor):
    return tensor.detach().cpu().numpy().astype(np.float64)


class correct_charm_y(Stage):  # noqa: N801
    """Parameters: nu_cc_container_keys, nubar_cc_container_keys."""

    def __init__(
        self,
        nu_cc_container_keys=("nue_cc", "numu_cc", "nutau_cc"),
        nubar_cc_container_keys=("nuebar_cc", "numubar_cc", "nutaubar_cc"),
        **std_kwargs,
    ):
        super().__init__(
            expected_params=(),
            expected_container_keys=(
                "true_energy", "true_coszen", "bjorken_y", "weights",
            ),
            **std_kwargs,
        )
        self.nucc_keys = list(nu_cc_container_keys)
        self.nubarcc_keys = list(nubar_cc_container_keys)
        self.all_cc_keys = self.nucc_keys + self.nubarcc_keys

    def setup_function(self):
        with open(find_resource(
                "cross_sections/charm_y_correction_2d_coszen_split.pckl"),
                "rb") as fl:
            hists = pickle.load(fl, encoding="latin1")
        xed = hists["bins_lgE"]
        yed = hists["bins_y"]

        def eval_hist(lg_e, y, coszen, nubar):
            ix = np.clip(np.digitize(lg_e, bins=xed), 1, len(xed) - 1) - 1
            iy = np.clip(np.digitize(y, bins=yed), 1, len(yed) - 1) - 1
            res = np.zeros_like(lg_e)
            upg = coszen < -0.9
            h_upg = hists["nubar_cc_upg" if nubar else "nu_cc_upg"]
            h_oth = hists["nubar_cc_oth" if nubar else "nu_cc_oth"]
            res[upg] = h_upg[ix[upg], iy[upg]]
            res[~upg] = h_oth[ix[~upg], iy[~upg]]
            return res

        for container in self.data:
            if container.name in self.nucc_keys:
                is_nubar = False
            elif container.name in self.nubarcc_keys:
                is_nubar = True
            else:
                continue
            lg_e = np.log10(_host(container["true_energy"]))
            y = _host(container["bjorken_y"])
            cz = _host(container["true_coszen"])
            corr = np.ones(container.size, dtype=FTYPE)
            apply_mask = y >= 0
            valid = (lg_e >= 0) & apply_mask
            extrp = (lg_e < 0) & apply_mask
            if valid.any():
                corr[valid] = eval_hist(lg_e[valid], y[valid], cz[valid],
                                        is_nubar)
            if extrp.any():
                corr[extrp] = eval_hist(np.zeros(extrp.sum()), y[extrp],
                                        cz[extrp], is_nubar)
            container["charm_y_distr_corr"] = corr

    def apply_function(self):
        for container in self.data:
            if container.name in self.all_cc_keys:
                container["weights"] = (
                    container["weights"] * container["charm_y_distr_corr"])


def init_test(**param_kwargs):
    """Instantiation example (keys chosen to match the smoke harness)."""
    return correct_charm_y(
        nu_cc_container_keys=["nutau_cc"],
        nubar_cc_container_keys=["numubar_nc"],
    )
