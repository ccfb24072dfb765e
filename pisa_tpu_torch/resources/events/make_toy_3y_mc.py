"""
Counterpart of ``pisa_tpu/resources/events/make_toy_3y_mc.py``: generate
the synthetic neutrino MC set in the IceCube 3-year data-release CSV schema
that stands in for the real ``neutrino_mc.csv.bz2`` (from
https://icecube.wisc.edu/science/data/highstats_nuosc_3y, not vendored), so
that the flagship ``IceCube_3y_neutrinos.cfg`` pipeline runs end to end.
:func:`make` draws exactly what the JAX script draws (the same seed, the
same order of draws); the committed file under
``pisa_tpu/resources/events/IceCube_3y_oscillations/`` is its output.

Schema (columns used by ``data.csv_loader``): pdg, type (0=NC, 1=CC),
true_energy, true_coszen, reco_energy, reco_coszen, pid (0=cascade,
1=track), weight (per-event effective area, m^2 — OneWeight-style such that
sum(weight * flux) * livetime gives event counts).

Write it with:
    python pisa_tpu_torch/resources/events/make_toy_3y_mc.py OUT.csv.bz2
"""

import sys

import numpy as np

SEED = 20260816
N_PER_CATEGORY = 20000
COLUMNS = ("pdg", "type", "true_energy", "true_coszen", "reco_energy",
           "reco_coszen", "pid", "weight")

# (pdg, type) per category; pdg = nubar*(12 + 2*flav)
CATEGORIES = []
for flav, base in (("e", 12), ("mu", 14), ("tau", 16)):
    for nubar in (1, -1):
        for current in (1, 0):  # CC, NC
            CATEGORIES.append((nubar * base, current, flav))


def toy_columns():
    """The 240,000 events as {column: array}, in the file's row order."""
    rng = np.random.RandomState(SEED)
    parts = []
    for pdg, current, flav in CATEGORIES:
        n = N_PER_CATEGORY
        # E^-1 sampling between 1.5 and 500 GeV (log-uniform)
        true_e = np.exp(rng.uniform(np.log(1.5), np.log(500.0), n))
        true_cz = rng.uniform(-1, 1, n)

        # effective area grows ~E^1.7 below ~100 GeV and saturates; taus
        # suppressed near threshold; NC "visible" area lower
        aeff = 2e-10 * true_e**1.7 / (1 + (true_e / 100.0) ** 1.7)
        if flav == "tau" and current == 1:
            aeff = aeff * np.clip((true_e - 3.5) / 30.0, 0, 1)
        if current == 0:
            aeff = aeff * 0.4
        # importance weight: sampled log-uniform => weight *= E to recover
        # an E-integrated effective area
        weight = aeff * true_e

        # reco smearing: NC events lose the outgoing neutrino energy
        visible_e = true_e * (0.4 if current == 0 else 1.0)
        reco_e = visible_e * rng.lognormal(0.0, 0.25, n)
        cz_sigma = 0.15 + 0.4 / np.sqrt(visible_e)
        reco_cz = np.clip(true_cz + rng.normal(0, cz_sigma, n), -1, 1)

        # PID: tracks from numu CC mostly; some tau CC; cascades otherwise
        if flav == "mu" and current == 1:
            p_track = np.clip(0.45 + 0.1 * np.log10(true_e), 0.3, 0.95)
        elif flav == "tau" and current == 1:
            p_track = 0.15 * np.ones(n)
        else:
            p_track = 0.05 * np.ones(n)
        pid = (rng.uniform(size=n) < p_track).astype(float)

        parts.append((np.full(n, pdg, dtype=int), np.full(n, current, dtype=int),
                      true_e, true_cz, reco_e, reco_cz, pid, weight))
    return {name: np.concatenate([p[i] for p in parts])
            for i, name in enumerate(COLUMNS)}


def make(path):
    """Write the events to `path` as bz2-compressed CSV (pandas' writer, as
    the JAX script writes them)."""
    import pandas as pd

    df = pd.DataFrame(toy_columns())
    df.to_csv(path, index=False, compression="bz2")
    print(f"wrote {len(df)} events -> {path}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} OUT.csv.bz2")
    make(sys.argv[1])
