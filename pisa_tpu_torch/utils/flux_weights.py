"""
Host copy of ``pisa_tpu/utils/flux_weights.py`` with its imports rewritten to
``pisa_tpu_torch``.

Atmospheric-flux table loading and integral-preserving evaluation.

Rebuild of the reference ``pisa/utils/flux_weights.py`` (``load_2d_honda_table:50``,
``load_2d_bartol_table:133``, ``load_2d_table:205``,
``calculate_2d_flux_weights:267-349``). The reference's scheme (IceCube
NuFlux-style "integral-preserving" interpolation):

1. per coszen band of the table, spline the *cumulative* flux integral over
   log10(energy) (knot grid offset half a table step); the flux at an energy
   is the spline's first derivative there;
2. per evaluation point, integrate those per-band derivatives cumulatively
   over coszen, spline the 21-knot cumulative, and take the derivative at
   the point's coszen.

The reference evaluates this in a per-event python loop building one scipy
spline per event (``calculate_2d_flux_weights:335-349``). Here both steps
are vectorized over all events: scipy ``CubicSpline`` objects hold the
per-band cumulative integrals with a 2-D y (bands on the second axis), the
per-event coszen spline is solved for all events at once (CubicSpline with
the event axis as extra dimension), and its derivative is evaluated at each
event's own coszen via gathered polynomial coefficients. scipy's FITPACK
interpolating spline (``splrep(s=0)``, what the reference uses) and
``CubicSpline(bc_type='not-a-knot')`` are the same cubic interpolant, so
results match the reference to floating-point round-off (validated in
``tests/test_flux_weights.py`` against a direct loop transcription of the
reference algorithm).

The nominal flux has no free (traced) parameters, so this evaluation is
host-side numpy/scipy, run once per setup/compute of ``flux.honda_ip``;
the resulting per-event flux arrays enter compiled templates as constants.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline

from pisa_tpu_torch.utils.resources import find_resource

__all__ = [
    "load_2d_honda_table",
    "load_2d_bartol_table",
    "load_2d_hillas_table",
    "load_2d_table",
    "calculate_2d_flux_weights",
    "load_3d_honda_table",
    "load_3d_table",
    "calculate_3d_flux_weights",
]

PRIMARIES = ["numu", "numubar", "nue", "nuebar"]
# Hillas-Gaisser H3a-style tables additionally carry prompt nutau columns
# (the reference's "hg_taumode", ``flux_weights.py:46,59``)
T_MODE_PRIMARIES = ["numu", "numubar", "nue", "nuebar", "nutau", "nutaubar"]


class FluxTable2D:
    """Integral-preserving 2-D (energy x coszen) flux table.

    Attributes
    ----------
    splines : dict primary -> CubicSpline over log10(E) whose y has shape
        (n_knots, n_cz_bands): cumulative flux integral per coszen band.
    cz_spline_points : (n_cz_bands + 1,) coszen knots for the second pass.
    name : 'honda' or 'bartol'
    """

    def __init__(self, splines, cz_spline_points, name):
        self.splines = splines
        self.cz_spline_points = np.asarray(cz_spline_points)
        self.name = name

    def __getitem__(self, primary):
        return self.splines[primary]

    def keys(self):
        return self.splines.keys()


def _read_table(flux_file):
    """Parse a Honda-format azimuth-averaged table: text header lines per
    coszen block, columns (energy, numu, numubar, nue, nuebar)."""
    table = np.genfromtxt(find_resource(flux_file), usecols=range(5))
    mask = np.all(np.isnan(table) | np.equal(table, 0), axis=1)
    table = table[~mask].T
    flux = dict(zip(["energy"] + PRIMARIES, table))
    for key in flux:
        # 20 coszen blocks, ordered cz = [0.95 ... -0.95] in the file
        flux[key] = np.array(np.split(flux[key], 20))
    flux["energy"] = flux["energy"][0]
    return flux


def _build(flux, logenergy_knots, de_steps, name, enpow=1,
           primaries=PRIMARIES):
    """Cumulative-integral splines per primary; bands ascending in coszen.

    `enpow`: power of E multiplied into the integrand ("spline works best if
    you integrate flux * energy", reference ``flux_weights.py:114``); the
    evaluation divides it back out.
    """
    splines = {}
    n_bands = None
    for prim in primaries:
        # file blocks are cz-descending; czkeys ascend
        bands = flux[prim][::-1]  # (n_cz, n_E), ascending coszen
        n_bands = bands.shape[0]
        # cumulative integral of flux*E^enpow over the table grid, 0 prepended
        cum = np.concatenate(
            [
                np.zeros((bands.shape[0], 1)),
                np.cumsum(
                    bands * flux["energy"] ** enpow * de_steps, axis=1
                ),
            ],
            axis=1,
        )  # (n_cz, n_knots)
        splines[prim] = CubicSpline(
            logenergy_knots, cum.T, axis=0, bc_type="not-a-knot"
        )
    return FluxTable2D(splines, np.linspace(-1, 1, n_bands + 1), name)


def load_2d_honda_table(flux_file, enpow=1):
    """Honda 2015 azimuth-averaged table -> integral-preserving splines
    (cf. reference ``flux_weights.py:50-131``)."""
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")
    flux = _read_table(flux_file)
    # 101 energies at 0.05 log10 steps; cumulative knots offset half a step
    logenergy_knots = np.linspace(-1.025, 4.025, 102)
    return _build(flux, logenergy_knots, 0.05, "honda", enpow=enpow)


def load_2d_bartol_table(flux_file, enpow=1):
    """Bartol 2004 table (Honda-ified format; cf. reference
    ``flux_weights.py:133-203``): 0.05 log steps below 10 GeV, 0.1 above."""
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")
    flux = _read_table(flux_file)
    steps = np.where(flux["energy"] < 10.0, 0.05, 0.1)
    logenergy_knots = np.concatenate(
        [np.linspace(-1, 1, 41), np.linspace(1.1, 4, 30)]
    )
    return _build(flux, logenergy_knots, steps, "bartol", enpow=enpow)


def load_2d_hillas_table(flux_file, enpow=1):
    """Hillas-Gaisser H3a-style table WITH prompt-nutau columns (the
    reference's "hg_taumode" format, ``flux_weights.py:50-131``): columns
    (energy, numu, numubar, nue, nuebar, nutau, nutaubar), 100 coszen
    blocks (cz-descending like Honda; band edges ``linspace(-1, 1, 101)``),
    100 log10-energy rows at 0.05 steps with cumulative-integral knots
    ``linspace(1, 6, 101)``."""
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")
    table = np.genfromtxt(find_resource(flux_file), usecols=range(7))
    mask = np.all(~np.isnan(table), axis=1)
    table = table[mask].T
    flux = dict(zip(["energy"] + T_MODE_PRIMARIES, table))
    for key in flux:
        flux[key] = np.array(np.split(flux[key], 100))
    flux["energy"] = flux["energy"][0]
    logenergy_knots = np.linspace(1.0, 6.0, 101)
    return _build(
        flux, logenergy_knots, 0.05, "hillas", enpow=enpow,
        primaries=T_MODE_PRIMARIES,
    )


def load_2d_table(flux_file, enpow=1):
    """Dispatch by table family (cf. reference ``flux_weights.py:205``)."""
    if "hillas" in flux_file or "h3a" in flux_file.lower():
        return load_2d_hillas_table(flux_file, enpow=enpow)
    if "aa" not in flux_file:
        raise ValueError("Azimuth-averaged tables are expected")
    if "honda" in flux_file:
        return load_2d_honda_table(flux_file, enpow=enpow)
    if "bartol" in flux_file:
        return load_2d_bartol_table(flux_file, enpow=enpow)
    raise ValueError(
        "Flux file must be from the Honda, Bartol or Hillas-Gaisser groups"
    )


def calculate_2d_flux_weights(
    true_energies, true_coszens, en_splines, enpow=1, out=None
):
    """Integral-preserving flux per (energy, coszen) point, vectorized
    (cf. reference ``flux_weights.py:267-349``).

    Parameters
    ----------
    true_energies, true_coszens : (N,) arrays (energies in GeV)
    en_splines : CubicSpline from a loaded table (one primary)
    """
    true_energies = np.asarray(true_energies, dtype=np.float64)
    true_coszens = np.asarray(true_coszens, dtype=np.float64)
    if true_energies.shape != true_coszens.shape:
        raise ValueError("length of energy and coszen arrays must match")
    if not ((true_coszens >= -1.0).all() and (true_coszens <= 1.0).all()):
        raise ValueError("Not all coszens found between -1 and 1")
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")

    log_e = np.log10(true_energies)
    # step 1: d(cumulative)/d(logE) at every event, all cz bands at once
    d = en_splines.derivative(1)(log_e)  # (N, n_cz)
    n_cz = d.shape[-1]
    # step 2: cumulative over coszen (knot spacing 2/n_cz: 0.1 for the
    # 20-band Honda/Bartol tables, 0.02 for the 100-band Hillas tables),
    # 0 prepended
    int_vals = np.concatenate(
        [
            np.zeros(log_e.shape + (1,)),
            np.cumsum(d, axis=-1) * (2.0 / n_cz),
        ],
        axis=-1,
    )  # (N, n_cz + 1)
    cz_points = np.linspace(-1, 1, n_cz + 1)
    cz_spline = CubicSpline(
        cz_points, int_vals.T, axis=0, bc_type="not-a-knot"
    )
    # derivative of each event's own spline at its own coszen: gather the
    # polynomial piece per event and evaluate d/dx of the cubic
    c = cz_spline.c  # (4, n_cz, N)
    k = np.clip(
        np.searchsorted(cz_points, true_coszens, side="right") - 1,
        0,
        n_cz - 1,
    )
    t = true_coszens - cz_points[k]
    idx = np.arange(true_coszens.size)
    kf = k.ravel()
    c0 = c[0].reshape(n_cz, -1)[kf, idx]
    c1 = c[1].reshape(n_cz, -1)[kf, idx]
    c2 = c[2].reshape(n_cz, -1)[kf, idx]
    tf = t.ravel()
    deriv = (3.0 * c0 * tf + 2.0 * c1) * tf + c2
    result = (deriv / true_energies.ravel() ** enpow).reshape(
        true_energies.shape
    )
    if out is not None:
        out[...] = result
        return out
    return result


# ---------------------------------------------------------------------------
# 3-D (energy x coszen x azimuth) tables
# (cf. reference ``flux_weights.py:352-604``)
# ---------------------------------------------------------------------------
class FluxTable3D:
    """Integral-preserving 3-D (energy x coszen x azimuth) flux table.

    Attributes
    ----------
    splines : dict primary -> CubicSpline over log10(E) whose y has shape
        (n_knots, 12 az, 20 cz): cumulative flux-integral per band.
    cz_spline_points : (21,) coszen knots for the second pass.
    az_points_deg : (12,) table azimuth band centers (15..345 degrees).
    name : 'honda'
    """

    def __init__(self, splines, cz_spline_points, az_points_deg, name):
        self.splines = splines
        self.cz_spline_points = np.asarray(cz_spline_points)
        self.az_points_deg = np.asarray(az_points_deg)
        self.name = name

    def __getitem__(self, primary):
        return self.splines[primary]

    def keys(self):
        return self.splines.keys()


def load_3d_honda_table(flux_file, enpow=1):
    """Honda azimuth-dependent table -> integral-preserving splines
    (cf. reference ``flux_weights.py:352-430``). File layout: 20 coszen
    blocks (descending from 0.95) x 12 azimuth blocks (ascending from 15
    deg) x 101 energies."""
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")
    table = np.genfromtxt(find_resource(flux_file), usecols=range(5))
    mask = np.all(np.isnan(table) | np.equal(table, 0), axis=1)
    table = table[~mask].T
    flux = dict(zip(["energy"] + PRIMARIES, table))

    n_cz, n_az = 20, 12
    energy = np.asarray(np.split(flux["energy"], n_cz * n_az))[0]
    n_e = energy.size
    logenergy_knots = np.linspace(-1.025, 4.025, n_e + 1)

    splines = {}
    for prim in PRIMARIES:
        # (cz_desc, az, E) from file order -> (az, cz ascending, E)
        bands = flux[prim].reshape(n_cz, n_az, n_e)
        bands = np.swapaxes(bands, 0, 1)[:, ::-1, :]
        cum = np.concatenate(
            [
                np.zeros((n_az, n_cz, 1)),
                np.cumsum(bands * energy**enpow * 0.05, axis=2),
            ],
            axis=2,
        )  # (12, 20, n_e+1)
        splines[prim] = CubicSpline(
            logenergy_knots,
            np.moveaxis(cum, 2, 0),  # (n_knots, 12, 20)
            axis=0,
            bc_type="not-a-knot",
        )
    return FluxTable3D(
        splines, np.linspace(-1, 1, n_cz + 1), np.linspace(15, 345, n_az),
        "honda",
    )


def load_3d_table(flux_file, enpow=1):
    """Dispatch for 3-D tables (cf. reference ``flux_weights.py:433``)."""
    if "aa" in flux_file:
        raise ValueError("Azimuth-dependent tables are expected")
    if "honda" not in flux_file:
        raise ValueError("Flux file must be from the Honda group")
    return load_3d_honda_table(flux_file, enpow=enpow)


def _percolumn_cubic_derivative(knots, int_vals, x):
    """Derivative of a per-column not-a-knot cubic interpolant at each
    column's own x: int_vals (M, n_knots), x (M,) -> (M,)."""
    n_seg = knots.size - 1
    spline = CubicSpline(knots, int_vals.T, axis=0, bc_type="not-a-knot")
    c = spline.c  # (4, n_seg, M)
    k = np.clip(np.searchsorted(knots, x, side="right") - 1, 0, n_seg - 1)
    t = x - knots[k]
    idx = np.arange(x.size)
    c0 = c[0][k, idx]
    c1 = c[1][k, idx]
    c2 = c[2][k, idx]
    return (3.0 * c0 * t + 2.0 * c1) * t + c2


def calculate_3d_flux_weights(
    true_energies, true_coszens, true_azimuths, en_splines, enpow=1,
    az_linear=True,
):
    """Integral-preserving flux per (energy, coszen, azimuth) point,
    vectorized (cf. reference ``flux_weights.py:474-604``: the reference
    builds two scipy splines per event per azimuth band in a python loop;
    here every stage is batched over all events).

    Parameters
    ----------
    true_energies : (N,) GeV
    true_coszens : (N,) in [-1, 1]
    true_azimuths : (N,) radians, >= 0
    en_splines : CubicSpline from a loaded :class:`FluxTable3D` (one
        primary)
    enpow : int
        Power of E used when the table was loaded.
    az_linear : bool
        Linear (cyclic) azimuth interpolation (recommended and default);
        False uses the integral-preserving treatment in azimuth too.
    """
    true_energies = np.asarray(true_energies, dtype=np.float64)
    true_coszens = np.asarray(true_coszens, dtype=np.float64)
    true_azimuths = np.asarray(true_azimuths, dtype=np.float64)
    if not (
        true_energies.shape == true_coszens.shape == true_azimuths.shape
    ):
        raise ValueError(
            "length of energy, coszen and azimuth arrays must match"
        )
    if not ((true_coszens >= -1.0).all() and (true_coszens <= 1.0).all()):
        raise ValueError("Not all coszens found between -1 and 1")
    if not (true_azimuths >= 0.0).all():
        raise ValueError(
            "Azimuths should be given as the angle, so should all be"
            " positive"
        )
    if not isinstance(enpow, int):
        raise TypeError("Energy power must be an integer")

    n = true_energies.size
    log_e = np.log10(true_energies.ravel())

    # (1) d(cumulative)/d(logE) at each event for all (az, cz) bands
    d = en_splines.derivative(1)(log_e)  # (N, 12, 20)
    n_az, n_cz = d.shape[1], d.shape[2]

    # (2) per (event, az): integral-preserving coszen interpolation
    int_vals = np.concatenate(
        [np.zeros((n, n_az, 1)), np.cumsum(d, axis=2) * 0.1], axis=2
    ).reshape(n * n_az, n_cz + 1)
    cz_points = np.linspace(-1, 1, n_cz + 1)
    cz_rep = np.repeat(true_coszens.ravel(), n_az)
    az_vals = _percolumn_cubic_derivative(
        cz_points, int_vals, cz_rep
    ).reshape(n, n_az)  # (N, 12)

    az_deg = true_azimuths.ravel() * (180.0 / np.pi)

    if az_linear:
        # cyclic linear interpolation on band centers 15..375 deg
        vals = az_vals / true_energies.ravel()[:, None] ** enpow
        vals = np.concatenate([vals, vals[:, :1]], axis=1)  # (N, 13)
        az_shift = np.where(az_deg < 15.0, az_deg + 360.0, az_deg)
        j = np.clip(((az_shift - 15.0) // 30.0).astype(int), 0, n_az - 1)
        w = (az_shift - (15.0 + 30.0 * j)) / 30.0
        idx = np.arange(n)
        out = vals[idx, j] * (1.0 - w) + vals[idx, j + 1] * w
    else:
        # integral-preserving in azimuth as well (not recommended;
        # reference ``flux_weights.py:580-590``)
        az_int = np.concatenate(
            [np.zeros((n, 1)), np.cumsum(az_vals, axis=1) * 30.0], axis=1
        )  # (N, 13)
        az_knots = np.linspace(0.0, 360.0, n_az + 1)
        out = _percolumn_cubic_derivative(az_knots, az_int, az_deg)
        out = out / true_energies.ravel() ** enpow

    return out.reshape(true_energies.shape)
