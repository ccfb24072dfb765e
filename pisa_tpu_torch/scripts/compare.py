"""
Compare reference vs test MapSets / pipelines (counterpart of
``pisa_tpu/scripts/compare.py``; cf. reference ``pisa/scripts/compare.py``):
per-map difference, fractional difference and asymmetry
((test-ref)/sqrt(ref)) maps, summary statistics, optional JSON and PDF/PNG
plot output, and a nonzero exit code when outside tolerance.

Inputs can be stored MapSet JSON files or pipeline config files; repeated
``--ref``/``--test`` options are summed (multi-pipeline distributions, as a
DistributionMaker would produce). Pipeline configs run on ``--device``
(the card by default).

Legacy short form ``pisa-tpu-torch-compare REF TEST [--rtol ...]`` is still
accepted.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["compare_distributions", "main"]


def _load_one(spec, param_selections=None, device="cuda"):
    from pisa_tpu_torch.core.map import MapSet
    from pisa_tpu_torch.core.pipeline import Pipeline

    if spec.endswith((".json", ".json.bz2")):
        return MapSet.from_json(spec)
    pipeline = Pipeline(spec, device=device)
    if param_selections:
        pipeline.select_params(param_selections)
    out = pipeline.get_outputs()
    if isinstance(out, list):  # VarBinning output
        raise ValueError(
            "compare does not support VarBinning pipeline outputs;"
            " store MapSets to json instead"
        )
    return out


def _load(specs, param_selections=None, device="cuda"):
    """Load and sum one or more MapSet sources (json or pipeline cfg)."""
    from pisa_tpu_torch.core.map import MapSet

    mapsets = [_load_one(s, param_selections, device) for s in specs]
    total = mapsets[0]
    for ms in mapsets[1:]:
        maps = []
        for m in total:
            if m.name in ms.names:
                maps.append(m + ms[m.name])
            else:
                maps.append(m)
        for m in ms:
            if m.name not in total.names:
                maps.append(m)
        total = MapSet(maps, name=total.name)
    return total


def compare_distributions(
    ref, test, ref_label="ref", test_label="test", rtol=1e-5, atol=0.0
):
    """Per-map comparison of two MapSets.

    Returns ``(summary, diff, fract_diff, asymm, all_close)`` where the
    middle three are MapSets (cf. reference ``compare.py:595``
    ``summary_stats, diff, fract_diff, asymm``) and ``summary`` is a
    JSON-serializable dict keyed by map name.
    """
    import numpy as np

    from pisa_tpu_torch.core.map import Map, MapSet

    summary = {}
    diff_maps, fdiff_maps, asymm_maps = [], [], []
    all_close = True

    for m_ref in ref:
        name = m_ref.name
        if name not in test.names:
            summary[name] = {"missing_in": test_label}
            all_close = False
            continue
        a = np.asarray(m_ref.hist, dtype=float)
        b = np.asarray(test[name].hist, dtype=float)
        diff = b - a
        with np.errstate(divide="ignore", invalid="ignore"):
            fdiff = np.where(
                a != 0, diff / a, np.where(diff == 0, 0.0, np.inf)
            )
            asymm = np.where(a > 0, diff / np.sqrt(a), np.nan)
        close = bool(
            np.allclose(b, a, rtol=rtol, atol=atol, equal_nan=True)
        )
        all_close &= close
        finite_fd = np.abs(fdiff[np.isfinite(fdiff)])
        summary[name] = {
            f"{ref_label}_total": float(a.sum()),
            f"{test_label}_total": float(b.sum()),
            "max_abs_diff": float(np.abs(diff).max()),
            "max_abs_fract_diff": float(
                finite_fd.max() if finite_fd.size else 0.0
            ),
            "nanmax_abs_asymm": float(np.nanmax(np.abs(asymm)))
            if np.isfinite(asymm).any()
            else None,
            "allclose": close,
        }
        binning = m_ref.binning
        diff_maps.append(Map(name=name, hist=diff, binning=binning))
        fdiff_maps.append(
            Map(name=name, hist=np.where(np.isfinite(fdiff), fdiff, np.nan),
                binning=binning)
        )
        asymm_maps.append(Map(name=name, hist=asymm, binning=binning))

    extra = sorted(set(test.names) - set(ref.names))
    if extra:
        summary["__extra_maps_in_test__"] = extra
        all_close = False

    return (
        summary,
        MapSet(diff_maps, name="diff"),
        MapSet(fdiff_maps, name="fract_diff"),
        MapSet(asymm_maps, name="asymm"),
        all_close,
    )


def _limits(vmin, vmax):
    """Symmetric limits when only one bound is given (reference behavior)."""
    if vmin is None and vmax is not None:
        vmin = -vmax
    elif vmax is None and vmin is not None:
        vmax = -vmin if vmin < 0 else vmin
        vmin = -vmax
    return vmin, vmax


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("legacy", nargs="*", metavar="REF TEST",
                        help="legacy positional form: REF TEST")
    parser.add_argument("--ref", action="append", default=[],
                        help="MapSet json or pipeline cfg (repeatable; summed)")
    parser.add_argument("--ref-label", default="ref")
    parser.add_argument("--ref-abs", action="store_true",
                        help="compare |ref|")
    parser.add_argument("--ref-param-selections", action="append",
                        help="param selections applied to --ref pipeline cfgs")
    parser.add_argument("--test", action="append", default=[],
                        help="MapSet json or pipeline cfg (repeatable; summed)")
    parser.add_argument("--test-label", default="test")
    parser.add_argument("--test-abs", action="store_true",
                        help="compare |test|")
    parser.add_argument("--test-param-selections", action="append",
                        help="param selections applied to --test pipeline cfgs")
    parser.add_argument("--combine", action="append",
                        help="combine maps by wildcard (repeatable)")
    parser.add_argument("--sum", nargs="+", metavar="AXIS",
                        help="sum over (remove) the given binning dimension(s)")
    parser.add_argument("--outdir", help="write outputs here")
    parser.add_argument("--json", action="store_true",
                        help="also store ref/test/diff/fract_diff/asymm MapSets"
                        " as json.bz2 in --outdir")
    parser.add_argument("--pdf", action="store_true")
    parser.add_argument("--png", action="store_true")
    parser.add_argument("--diff-min", type=float)
    parser.add_argument("--diff-max", type=float)
    parser.add_argument("--fract-diff-min", type=float)
    parser.add_argument("--fract-diff-max", type=float)
    parser.add_argument("--asymm-min", type=float)
    parser.add_argument("--asymm-max", type=float)
    parser.add_argument("--rtol", type=float, default=1e-5)
    parser.add_argument("--atol", type=float, default=0.0)
    parser.add_argument("--device", default="cuda",
                        help="device of the pipeline cfgs (default: cuda)")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)

    if args.legacy:
        if len(args.legacy) != 2 or args.ref or args.test:
            parser.error("positional form takes exactly REF TEST")
        args.ref, args.test = [args.legacy[0]], [args.legacy[1]]
    if not args.ref or not args.test:
        parser.error("provide --ref and --test (or the legacy REF TEST form)")
    if (args.pdf or args.png or args.json) and not args.outdir:
        parser.error("--json/--pdf/--png require --outdir")

    import numpy as np

    ref = _load(args.ref, args.ref_param_selections, args.device)
    test = _load(args.test, args.test_param_selections, args.device)

    if args.combine:
        ref = ref.combine_wildcard(args.combine)
        test = test.combine_wildcard(args.combine)
    if args.sum:
        from pisa_tpu_torch.core.map import MapSet

        ref = MapSet([m.sum(axis=list(args.sum)) for m in ref], name=ref.name)
        test = MapSet(
            [m.sum(axis=list(args.sum)) for m in test], name=test.name
        )
    if args.ref_abs or args.test_abs:
        from pisa_tpu_torch.core.map import Map, MapSet

        def _absolutify(ms):
            return MapSet(
                [
                    Map(name=m.name, hist=np.abs(np.asarray(m.hist)),
                        binning=m.binning)
                    for m in ms
                ],
                name=ms.name,
            )

        if args.ref_abs:
            ref = _absolutify(ref)
        if args.test_abs:
            test = _absolutify(test)

    summary, diff, fdiff, asymm, ok = compare_distributions(
        ref, test, args.ref_label, args.test_label, args.rtol, args.atol
    )

    for name, s in summary.items():
        if name == "__extra_maps_in_test__":
            print(f"  extra maps in {args.test_label}: {s}")
            continue
        if "missing_in" in s:
            print(f"  {name}: MISSING in {s['missing_in']}")
            continue
        print(
            f"  {name}: max|diff|={s['max_abs_diff']:.4g}"
            f" max|fdiff|={s['max_abs_fract_diff']:.4g}"
            f" totals {s[f'{args.ref_label}_total']:.6g} vs"
            f" {s[f'{args.test_label}_total']:.6g}"
            f" {'OK' if s['allclose'] else 'MISMATCH'}"
        )

    if args.outdir:
        from pisa_tpu_torch.utils.jsons import to_json

        os.makedirs(args.outdir, exist_ok=True)
        base = f"{args.test_label}__vs__{args.ref_label}"
        to_json(summary, os.path.join(args.outdir, f"{base}.summary.json"))
        if args.json:
            for label, ms in [
                (args.ref_label, ref),
                (args.test_label, test),
                ("diff", diff),
                ("fract_diff", fdiff),
                ("asymm", asymm),
            ]:
                ms.to_json(
                    os.path.join(args.outdir, f"{base}.{label}.json.bz2")
                )
        if args.pdf or args.png:
            from pisa_tpu_torch.utils.plotter import Plotter

            fmts = [f for f, on in [("pdf", args.pdf), ("png", args.png)] if on]
            plotter = Plotter(
                outdir=args.outdir, fmt=fmts, log=False, symmetric=True
            )
            panels = [
                (args.ref_label, ref, (None, None)),
                (args.test_label, test, (None, None)),
                ("diff", diff, _limits(args.diff_min, args.diff_max)),
                ("fract_diff", fdiff,
                 _limits(args.fract_diff_min, args.fract_diff_max)),
                ("asymm", asymm, _limits(args.asymm_min, args.asymm_max)),
            ]
            for label, ms, (vmin, vmax) in panels:
                kw = {}
                if vmin is not None:
                    kw["vmin"] = vmin
                if vmax is not None:
                    kw["vmax"] = vmax
                if len(ms) and len(ms[ms.names[0]].binning.names) == 1:
                    axis = ms[ms.names[0]].binning.names[0]
                    plotter.plot_1d_all(ms, axis, fname=f"{base}.{label}")
                else:
                    plotter.plot_2d_array(ms, fname=f"{base}.{label}", **kw)

    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
