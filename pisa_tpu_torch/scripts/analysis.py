"""
Run an Asimov (or data) fit of a hypothesis to a distribution (counterpart
of ``pisa_tpu/scripts/analysis.py``; cf. reference ``pisa-analysis``-style
workflows): build a DistributionMaker from pipeline config(s) on
``--device`` (the card by default), generate/load the data distribution,
fit with the requested method, and save the HypoFitResult.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-p", "--pipeline", action="append", required=True,
        help="hypothesis pipeline config (repeatable)",
    )
    parser.add_argument(
        "--data", default=None,
        help="data MapSet json (default: Asimov at nominal params)",
    )
    parser.add_argument("--metric", default="mod_chi2")
    parser.add_argument(
        "--method", default="gradient",
        help="fit method: gradient | device | scipy | octants | best_of | ...",
    )
    parser.add_argument("--select-params", default=None)
    parser.add_argument("-o", "--outfile", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the hypothesis and the fit (default: cuda)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    from pisa_tpu_torch.analysis.analysis import Analysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.core.map import MapSet
    from pisa_tpu_torch.utils.fileio import to_file
    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)
    dm = DistributionMaker(args.pipeline, device=args.device)
    if args.select_params:
        dm.select_params([s.strip() for s in args.select_params.split(",")])

    if args.data:
        data_dist = MapSet.from_json(args.data)
    else:
        data_dist = dm.get_outputs(return_sum=True)

    ana = Analysis()
    result = ana.fit_recursively(
        data_dist, dm, args.metric, None, args.method, {}, None
    )
    print(f"best-fit {args.metric}: {float(result.metric_val):.6g}")
    for p in result.params.free:
        print(f"  {p.name} = {p.value}")
    if args.outfile:
        to_file(result.state, args.outfile)
        print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
