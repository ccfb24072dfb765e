"""
Generate a (possibly multi-pipeline) distribution and save it (counterpart
of ``pisa_tpu/scripts/distribution_maker.py``; cf. reference
``pisa/core/distribution_maker.py:616`` CLI). The pipelines run on
``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-p", "--pipeline", action="append", required=True,
        help="pipeline config (repeatable)",
    )
    parser.add_argument("--outdir", default=None)
    parser.add_argument("--return-sum", action="store_true")
    parser.add_argument("--select-params", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipelines (default: cuda)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    import numpy as np

    from pisa_tpu_torch.core.distribution_maker import DistributionMaker
    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)
    dm = DistributionMaker(args.pipeline, device=args.device)
    if args.select_params:
        dm.select_params([s.strip() for s in args.select_params.split(",")])
    outputs = dm.get_outputs(return_sum=args.return_sum)
    mapsets = [outputs] if not isinstance(outputs, list) else outputs
    for ms in mapsets:
        for m in ms:
            print(f"  {m.name}: total {float(np.asarray(m.hist).sum()):.4g}")
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        for i, ms in enumerate(mapsets):
            path = os.path.join(args.outdir, f"distribution_{i}.json.bz2")
            ms.to_json(path)
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
