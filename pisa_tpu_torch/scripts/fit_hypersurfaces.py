"""
Fit hypersurfaces from a nominal and systematic pipeline datasets
definition (counterpart of ``pisa_tpu/scripts/fit_hypersurfaces.py``;
reference ``pisa/scripts/fit_hypersurfaces.py`` and
``hypersurface.py:1598``).

The fit config is a JSON file:

    {
      "pipeline_cfg": "settings/pipeline/....cfg",
      "combine_regex": ["nue.*_cc", ...],           # optional
      "params": {"opt_eff_overall": "linear", ...},
      "nominal_dataset": {"param_values": {...}},
      "sys_datasets": [{"param_values": {...}}, ...],
      "log": false, "norm": true
    }

Each dataset's `param_values` are applied to the pipeline before computing
its MapSet. Output: one JSON with all fitted hypersurfaces (with their
covariances), loadable by the discr_sys.hypersurfaces stage. The pipeline
and the fit run on ``--device`` (the card by default).

    python -m pisa_tpu_torch.scripts.fit_hypersurfaces fit.json -o hs.json
"""

from __future__ import annotations

import argparse


def fit_hypersurfaces_from_pipeline(
    pipeline_cfg, params, nominal_param_values, sys_param_values,
    combine_regex=None, log=False, norm=True, device="cuda",
):
    """Drive a pipeline on `device` over the nominal and systematic
    parameter points and fit hypersurfaces per map (there too)."""
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils.hypersurface import fit_hypersurfaces_from_maps

    pipeline = Pipeline(pipeline_cfg, device=device)

    def make_mapset(param_values):
        for name, value in param_values.items():
            prm = pipeline.params[name]
            if not hasattr(value, "units"):
                value = value * prm.value.units  # magnitudes in param units
            prm.value = value
        out = pipeline.get_outputs()
        if combine_regex:
            out = out.combine_re(combine_regex)
        return out

    nominal_mapset = make_mapset(nominal_param_values)
    sys_mapsets = [make_mapset(pv) for pv in sys_param_values]
    binning = pipeline.output_binning

    return fit_hypersurfaces_from_maps(
        nominal_mapset=nominal_mapset,
        nominal_param_values=nominal_param_values,
        sys_mapsets=sys_mapsets,
        sys_param_values=sys_param_values,
        binning=binning,
        params=params,
        log=log,
        norm=norm,
        include_nominal=False,
        device=device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "fit_cfg", nargs="?", help="JSON fit configuration (see docstring)"
    )
    parser.add_argument("-o", "--outfile")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipeline and the fit (default: cuda)",
    )
    # interpolated-fit job workflow (reference hyper_interpolator.py:
    # prepare_interpolated_fit/run_interpolated_fit/assemble_interpolated_fits)
    parser.add_argument(
        "--fit-directory",
        help="directory for per-gridpoint interpolated-fit jobs",
    )
    parser.add_argument(
        "--prepare",
        action="store_true",
        help="lay out metadata + gridpoint files; fit_cfg must contain an"
        " 'interpolation_param_spec' section",
    )
    parser.add_argument(
        "--run-job", type=int, default=None, metavar="IDX",
        help="run the fit for one grid point (job-array entry point)",
    )
    parser.add_argument(
        "--skip-successful", action="store_true",
        help="with --run-job: no-op if the job already succeeded (resume)",
    )
    parser.add_argument(
        "--assemble", action="store_true",
        help="combine all finished gridpoint fits into --outfile",
    )
    parser.add_argument(
        "--incomplete", action="store_true",
        help="print indices of unfinished jobs and exit",
    )
    args = parser.parse_args(argv)

    from pisa_tpu_torch.utils.fileio import from_file
    from pisa_tpu_torch.utils.hypersurface import (
        assemble_interpolated_fits,
        get_incomplete_job_idx,
        prepare_interpolated_fit,
        run_interpolated_fit,
        save_hypersurfaces,
    )
    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)

    if args.prepare or args.run_job is not None or args.assemble or (
        args.incomplete
    ):
        if not args.fit_directory:
            parser.error("job workflow requires --fit-directory")
        if args.prepare:
            cfg = from_file(args.fit_cfg)
            spec = cfg.pop("interpolation_param_spec")
            n = prepare_interpolated_fit(args.fit_directory, spec, cfg)
            print(f"prepared {n} jobs in {args.fit_directory}")
        if args.run_job is not None:
            run_interpolated_fit(
                args.fit_directory, args.run_job,
                skip_successful=args.skip_successful, device=args.device,
            )
        if args.incomplete:
            print(get_incomplete_job_idx(args.fit_directory))
        if args.assemble:
            if not args.outfile:
                parser.error("--assemble requires --outfile")
            assemble_interpolated_fits(args.fit_directory, args.outfile)
            print(f"assembled -> {args.outfile}")
        return 0

    if not args.fit_cfg or not args.outfile:
        parser.error("single fit requires fit_cfg and --outfile")
    cfg = from_file(args.fit_cfg)
    surfaces = fit_hypersurfaces_from_pipeline(
        pipeline_cfg=cfg["pipeline_cfg"],
        params=cfg["params"],
        nominal_param_values=cfg["nominal_dataset"]["param_values"],
        sys_param_values=[d["param_values"] for d in cfg["sys_datasets"]],
        combine_regex=cfg.get("combine_regex"),
        log=cfg.get("log", False),
        norm=cfg.get("norm", True),
        device=args.device,
    )
    save_hypersurfaces(surfaces, args.outfile)
    print(f"wrote {len(surfaces)} hypersurfaces -> {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
