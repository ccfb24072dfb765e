"""
Host copy of ``pisa_tpu/scripts/make_toy_events.py`` with its imports
rewritten to ``pisa_tpu_torch``: the same events for the same seed, from
the port's ``utils/flux_weights.py``, written by the port's own HDF5
writer (``utils/hdf.py:to_hdf``).

Generate a PISA-format toy MC events HDF5 file (cf. reference
``pisa/scripts/make_toy_events.py``): per-flavor/interaction groups with
truth, smeared reco, PID and weighted-aeff variables plus nominal Honda
fluxes — loadable by ``data.simple_data_loader``.
"""

from __future__ import annotations

import argparse

import numpy as np


def make_toy_events(
    num_events=1000,
    energy_range=(1.0, 80.0),
    spectral_index=1.0,
    coszen_range=(-1.0, 1.0),
    seed=0,
    flux_table="flux/honda-2015-spl-solmin-aa.d",
):
    """Toy events dict {flav: {cc/nc: {var: array}}} (legacy nested layout,
    exercising the loader's format handling)."""
    from pisa_tpu_torch.utils.flux_weights import (
        calculate_2d_flux_weights,
        load_2d_table,
    )

    rng = np.random.RandomState(seed)
    table = load_2d_table(flux_table)

    e_lo, e_hi = energy_range
    cz_lo, cz_hi = coszen_range

    out = {}
    for flav in ("nue", "nue_bar", "numu", "numu_bar", "nutau", "nutau_bar"):
        out[flav] = {}
        for int_type in ("cc", "nc"):
            n = int(num_events)
            # power-law energy sampling (E^-gamma on the range)
            u = rng.uniform(size=n)
            if spectral_index == 1.0:
                true_e = e_lo * (e_hi / e_lo) ** u
            else:
                g = 1.0 - spectral_index
                true_e = (
                    u * (e_hi**g - e_lo**g) + e_lo**g
                ) ** (1.0 / g)
            true_cz = rng.uniform(cz_lo, cz_hi, n)

            visible = true_e * (0.4 if int_type == "nc" else 1.0)
            reco_e = visible * rng.lognormal(0.0, 0.2, n)
            reco_cz = np.clip(
                true_cz + rng.normal(0, 0.2 / np.sqrt(visible) + 0.05, n),
                -1, 1,
            )
            if flav.startswith("numu") and int_type == "cc":
                pid = rng.uniform(0, 3, n)
            else:
                pid = rng.uniform(-3, 1, n)

            aeff = 1e-5 * true_e**2 / (1 + (true_e / 50.0) ** 2)
            fluxes = {}
            for prim in ("nue", "numu", "nuebar", "numubar"):
                fluxes[prim] = calculate_2d_flux_weights(
                    true_e, true_cz, table[prim]
                )
            group = {
                "true_energy": true_e,
                "true_coszen": true_cz,
                "reco_energy": reco_e,
                "reco_coszen": reco_cz,
                "pid": pid,
                "weighted_aeff": aeff,
                "nominal_nue_flux": fluxes["nue"],
                "nominal_numu_flux": fluxes["numu"],
                "nominal_nuebar_flux": fluxes["nuebar"],
                "nominal_numubar_flux": fluxes["numubar"],
            }
            out[flav][int_type] = group
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-o", "--outfile", required=True)
    parser.add_argument("--num-events", type=int, default=1000)
    parser.add_argument("--energy-range", type=float, nargs=2, default=(1, 80))
    parser.add_argument("--spectral-index", type=float, default=1.0)
    parser.add_argument("--coszen-range", type=float, nargs=2, default=(-1, 1))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from pisa_tpu_torch.utils.hdf import to_hdf

    events = make_toy_events(
        num_events=args.num_events,
        energy_range=tuple(args.energy_range),
        spectral_index=args.spectral_index,
        coszen_range=tuple(args.coszen_range),
        seed=args.seed,
    )
    to_hdf(events, args.outfile)
    print(f"wrote toy events -> {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
