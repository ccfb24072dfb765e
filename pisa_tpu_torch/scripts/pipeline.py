"""
Run a pipeline from a config and inspect/save its outputs (counterpart of
``pisa_tpu/scripts/pipeline.py``; cf. reference ``pisa/core/pipeline.py:1052``
CLI). The pipeline runs on ``--device`` (the card by default).

Examples
--------
    python -m pisa_tpu_torch.scripts.pipeline \\
        settings/pipeline/osc_example.cfg --outdir /tmp/out
    python -m pisa_tpu_torch.scripts.pipeline cfg --select-params nh \\
        --stop-after-stage osc.prob3
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", help="pipeline config file")
    parser.add_argument("--outdir", default=None, help="write outputs here")
    parser.add_argument(
        "--select-params", default=None,
        help="comma-separated param selections (e.g. 'nh')",
    )
    parser.add_argument(
        "--stop-after-stage", default=None,
        help="only run stages up to and including this one"
        " (index or 'stage.service')",
    )
    parser.add_argument(
        "--compile", action="store_true",
        help="evaluate via the compiled template (on a CUDA device: its"
        " call captured in a CUDA graph)",
    )
    parser.add_argument(
        "--profile", action="store_true", help="report per-stage timing"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipeline (default: cuda)",
    )
    parser.add_argument("-v", "--verbose", action="count", default=0)
    args = parser.parse_args(argv)

    import numpy as np

    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.utils.log import set_verbosity

    set_verbosity(args.verbose)

    t0 = time.time()
    pipeline = Pipeline(args.config, device=args.device, profile=args.profile)
    if args.select_params:
        pipeline.select_params(
            [s.strip() for s in args.select_params.split(",")]
        )
    print(f"setup: {time.time() - t0:.2f}s; stages: "
          + ", ".join(str(s) for s in pipeline.stages))

    if args.stop_after_stage is not None:
        try:
            idx = int(args.stop_after_stage)
        except ValueError:
            idx = pipeline.index(args.stop_after_stage)
        for stage in pipeline.stages[: idx + 1]:
            stage.run()
        print(f"ran stages 0..{idx}; container keys:")
        for c in pipeline.data:
            print(f"  {c.name}: {sorted(c.all_keys)}")
        return 0

    t0 = time.time()
    if args.compile:
        outputs = pipeline.compile().get_outputs()
    else:
        outputs = pipeline.get_outputs()
    print(f"get_outputs: {time.time() - t0:.2f}s")

    maps = outputs if not isinstance(outputs, list) else outputs[0]
    for m in maps:
        print(f"  {m.name}: total {float(np.asarray(m.hist).sum()):.4g}")

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        path = os.path.join(args.outdir, f"{pipeline.name}__outputs.json.bz2")
        maps.to_json(path)
        print(f"wrote {path}")

    if args.profile:
        pipeline.report_profile()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
