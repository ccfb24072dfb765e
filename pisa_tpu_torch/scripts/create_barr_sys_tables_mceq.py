"""
Host copy of ``pisa_tpu/scripts/create_barr_sys_tables_mceq.py``: the
Barr-block math is the same numpy; ``main`` exits as the JAX one does where
``MCEq`` cannot be imported.

Generate Barr-block flux gradient tables with MCEq (cf. reference
``pisa-create_barr_sys_tables_mceq``, ``pisa/scripts/create_barr_sys_tables_mceq.py``):
run MCEq for the nominal hadronic-production model and for each +/- Barr
phase-space-block perturbation, build central-difference flux gradients, and
write the 2-D (energy, coszen) spline tables consumed by the
``flux.mceq_barr`` / ``flux.mceq_barr_red`` services.

The Barr-block geometry and the Barr et al. PRD 74 094009 (2006)
energy-dependent uncertainty envelope are implemented here as plain numpy
(unit-testable without MCEq); only the transport solve itself requires the
external MCEq package, which is import-gated exactly like the reference
treats it (an OPTIONAL_MODULE in ``pisa_tests/run_unit_tests.py:52-66``).
"""

from __future__ import annotations

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

import numpy as np

# Barr phase-space blocks (Barr et al. 2006, Figs. 2-3): for each named
# parameter, the (x_lab, E_projectile) rectangles it perturbs, where
# x_lab = E_secondary / E_projectile. 'a'..'i' modify pi+ production,
# 'w'..'z' pi-, 'ch_*' kaons. Physics constants shared with the reference.
BARR_BLOCKS = {
    "a": [(0.0, 0.5, 0.00, 8.0)],
    "b1": [(0.5, 1.0, 0.00, 8.0)],
    "b2": [(0.6, 1.0, 8.00, 15.0)],
    "c": [(0.2, 0.6, 8.00, 15.0)],
    "d1": [(0.0, 0.2, 8.00, 15.0)],
    "d2": [(0.0, 0.1, 15.0, 30.0)],
    "d3": [(0.1, 0.2, 15.0, 30.0)],
    "e": [(0.2, 0.6, 15.0, 30.0)],
    "f": [(0.6, 1.0, 15.0, 30.0)],
    "g": [(0.0, 0.1, 30.0, 1e11)],
    "h1": [(0.1, 1.0, 30.0, 500.0)],
    "h2": [(0.1, 1.0, 500.0, 1e11)],
    "i": [(0.1, 1.0, 500.0, 1e11)],
    "w1": [(0.0, 1.0, 0.00, 8.0)],
    "w2": [(0.0, 1.0, 8.00, 15.0)],
    "w3": [(0.0, 0.1, 15.0, 30.0)],
    "w4": [(0.1, 0.2, 15.0, 30.0)],
    "w5": [(0.0, 0.1, 30.0, 500.0)],
    "w6": [(0.0, 0.1, 500.0, 1e11)],
    "x": [(0.2, 1.0, 15.0, 30.0)],
    "y1": [(0.1, 1.0, 30.0, 500.0)],
    "y2": [(0.1, 1.0, 500.0, 1e11)],
    "z": [(0.1, 1.0, 500.0, 1e11)],
    "ch_a": [(0.0, 0.1, 0.0, 1e11)],
    "ch_b": [(0.1, 1.0, 0.0, 1e11)],
    "ch_e": [(0.1, 1.0, 800.0, 1e11)],
}

# Blocks whose envelope keeps growing logarithmically above E_thr instead of
# saturating at a fixed maximum (high-energy extrapolation regions).
_LOG_GROWTH = frozenset(("i", "z", "ch_e"))
# (E_thr [GeV], saturation error, expected error at threshold decade)
_ENVELOPE = {
    "default": (30.0, 0.122, 0.122),
    "i": (500.0, np.inf, 0.122),
    "z": (500.0, np.inf, 0.122),
    "ch_e": (800.0, np.inf, 0.122),
}


def barr_envelope(energy, block, value):
    """Barr-2006 energy-dependent fractional modification for one block.

    Below the block's threshold energy the modification is ``value``
    (interpreted as a fractional yield change); above it the uncertainty
    envelope grows as ``0.122 * log10(E / E_thr)`` (the extrapolation
    uncertainty of Barr Fig. 9), capped at saturation for bounded blocks.
    Vectorized over ``energy`` (GeV).
    """
    energy = np.asarray(energy, dtype=float)
    e_thr, maxerr, expected = _ENVELOPE.get(block, _ENVELOPE["default"])
    scale = np.ones_like(energy)
    above = energy > e_thr
    with np.errstate(divide="ignore"):
        growth = 0.122 / expected * np.log10(
            np.where(above, energy / e_thr, 1.0)
        )
    scale = np.where(above, np.minimum(maxerr / expected, 1.0 + growth), scale)
    return value * scale


def block_mod_matrix(x_mat, e_grid, block, value):
    """Multiplicative production-yield modification over MCEq's (x, E) grid.

    ``x_mat[i, j]`` is x_lab of secondary-energy bin i at projectile-energy
    bin j (upper-triangular by kinematics). Returns a same-shape matrix of
    ``1 + delta`` factors, 1 outside the block's rectangles.
    """
    mod = np.ones_like(x_mat)
    env = barr_envelope(e_grid, block, value)
    for x_lo, x_hi, e_lo, e_hi in BARR_BLOCKS[block]:
        e_sel = (e_grid > e_lo) & (e_grid <= e_hi)
        in_block = (x_mat >= x_lo) & (x_mat <= x_hi) & e_sel[None, :]
        mod = np.where(in_block, 1.0 + env[None, :], mod)
    # kinematically forbidden region (x_lab > 1 encoded as lower triangle)
    mod[np.tril_indices(mod.shape[0], -1)] = 1.0
    return mod


def main(argv=None):
    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("--output-dir", default=".")
    parser.add_argument("--interaction-model", default="SIBYLL23C")
    parser.add_argument("--primary-model", default="HillasGaisser2012:H3a")
    parser.add_argument(
        "--barr-blocks", default=",".join(sorted(BARR_BLOCKS)),
        help="comma-separated Barr blocks to perturb",
    )
    parser.add_argument("--delta", type=float, default=0.2,
                        help="perturbation size for central differences")
    parser.add_argument("--cz-steps", type=int, default=21,
                        help="coszen grid points in [-1, 1]")
    args = parser.parse_args(argv)

    try:
        from MCEq.core import MCEqRun
        import crflux.models as crf
    except ImportError as exc:
        raise SystemExit(
            "the external MCEq package is required to generate Barr gradient "
            "tables (its *outputs* are what pisa-tpu's flux.mceq_barr "
            "services consume); the Barr-block math above is available "
            "without it as pisa_tpu_torch.scripts.create_barr_sys_tables_mceq"
        ) from exc

    import pickle

    pm_name, pm_tag = args.primary_model.split(":")
    mceq = MCEqRun(
        interaction_model=args.interaction_model,
        primary_model=(getattr(crf, pm_name), pm_tag),
        theta_deg=0.0,
    )
    e_grid = mceq.e_grid
    cz = np.linspace(-1.0, 1.0, args.cz_steps)
    blocks = [b for b in args.barr_blocks.split(",") if b]

    # projectile/secondary species touched per block family
    family = lambda b: (  # noqa: E731
        [(2212, 211)] if not b.startswith(("w", "ch")) else
        [(2212, -211)] if b.startswith("w") else
        [(2212, 321), (2212, -321)]
    )

    def solve_all(modify=None):
        """flux[species][i_cz, i_E] for nu/nubar e/mu (+ conv totals)."""
        out = {s: np.zeros((len(cz), len(e_grid)))
               for s in ("numu", "numubar", "nue", "nuebar")}
        for i, c in enumerate(cz):
            mceq.set_theta_deg(np.degrees(np.arccos(c)))
            if modify is not None:
                modify()
            mceq.solve()
            for s in out:
                out[s][i] = mceq.get_solution(f"total_{s}", mag=0)
        return out

    nominal = solve_all()
    tables = {"e_grid": e_grid, "cz_grid": cz, "nominal": nominal,
              "gradients": {}}
    for block in blocks:
        grads = {}
        for sign in (+1.0, -1.0):
            def modify(block=block, sign=sign):
                mceq.unset_mod_pprod(dont_fill=True)
                for proj, sec in family(block):
                    mceq.set_mod_pprod(
                        proj, sec, block_mod_matrix, (block, sign * args.delta)
                    )
                mceq.regenerate_matrices(skip_decay_matrix=True)
            grads[sign] = solve_all(modify)
        tables["gradients"][block] = {
            s: (grads[+1.0][s] - grads[-1.0][s]) / (2 * args.delta)
            for s in nominal
        }
        print(f"# block {block}: gradients done", flush=True)

    import os

    out_path = os.path.join(
        args.output_dir,
        f"barr_gradients_{args.interaction_model}.pkl",
    )
    with open(out_path, "wb") as f:
        pickle.dump(tables, f)
    print(f"# wrote {out_path}")


if __name__ == "__main__":
    main()
