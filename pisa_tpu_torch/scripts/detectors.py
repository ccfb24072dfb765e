"""
Generate distributions for several detectors jointly (counterpart of
``pisa_tpu/scripts/detectors.py``; cf. reference ``pisa/core/detectors.py:484``
CLI). The pipelines run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "-p", "--pipeline", action="append", required=True,
        help="pipeline config (repeatable; group by detector_name)",
    )
    parser.add_argument(
        "--shared-params", default=None,
        help="comma-separated params shared across detectors",
    )
    parser.add_argument("--outdir", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipelines (default: cuda)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    import numpy as np

    from pisa_tpu_torch.core.detectors import Detectors
    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)
    shared = (
        [s.strip() for s in args.shared_params.split(",")]
        if args.shared_params
        else None
    )
    det = Detectors(args.pipeline, shared_params=shared, device=args.device)
    outputs = det.get_outputs(return_sum=True)
    for name, ms in zip(det.det_names, outputs):
        for m in ms:
            print(
                f"  [{name}] {m.name}: total"
                f" {float(np.asarray(m.hist).sum()):.4g}"
            )
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        for name, ms in zip(det.det_names, outputs):
            path = os.path.join(args.outdir, f"{name}__outputs.json.bz2")
            ms.to_json(path)
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
