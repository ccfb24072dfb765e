"""
Benchmark pipeline template throughput (counterpart of
``pisa_tpu/scripts/benchmark.py``; cf. reference
``pisa/scripts/benchmark_pipeline_performance.py``): N randomized-parameter
templates (rescaled values uniform in [0.05, 0.95], seed 0), first call
(the capture) excluded; prints avg/min/max wall time and templates/s.

Routes: by default the compiled template's call ``ct(vec)`` (on a CUDA
device a replay of its captured graph) with the maps' totals read, one
wait a template; ``--in-device`` all templates back to back through
``CompiledTemplate.scan_totals`` (one wait for the whole scan);
``--eager`` the stage-by-stage ``Pipeline.get_outputs``. The pipelines
run on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", nargs="+", help="pipeline config(s)")
    parser.add_argument("-n", "--num-templates", type=int, default=50)
    parser.add_argument(
        "--eager", action="store_true",
        help="per-stage eager evaluation instead of the compiled template",
    )
    parser.add_argument(
        "--in-device", action="store_true",
        help="evaluate all templates back-to-back with no wait in between"
        " (CompiledTemplate.scan_totals) — removes the per-call host"
        " round-trip; reports the average over the whole scan",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the pipelines (default: cuda)",
    )
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from pisa_tpu_torch.core.pipeline import Pipeline

    for cfg in args.config:
        pipeline = Pipeline(cfg, device=args.device)
        rng = np.random.RandomState(0)
        times = []
        if args.eager:
            free = pipeline.params.free
            pipeline.get_outputs()  # exclude first call
            for _ in range(args.num_templates):
                for prm in free:
                    lo, hi = prm.range
                    prm.value = lo + (hi - lo) * float(rng.uniform(0.05, 0.95))
                t0 = time.time()
                pipeline.get_outputs()
                times.append(time.time() - t0)
        elif args.in_device:
            ct = pipeline.compile()
            n_free = len(ct.current_rescaled_values())
            vecs = rng.uniform(0.05, 0.95, size=(args.num_templates, n_free))
            ct.scan_totals(vecs).cpu()  # capture, excluded
            t0 = time.time()
            ct.scan_totals(vecs + 1e-6).cpu()
            per = (time.time() - t0) / args.num_templates
            times = [per] * args.num_templates
        else:
            ct = pipeline.compile()

            def total(v):
                with torch.no_grad():
                    return float(sum(h.sum() for h in ct(v)["hist"].values()))

            n_free = len(ct.current_rescaled_values())
            total(ct.current_rescaled_values())  # capture, excluded
            for _ in range(args.num_templates):
                v = rng.uniform(0.05, 0.95, n_free)
                t0 = time.time()
                total(v)
                times.append(time.time() - t0)
        times = np.asarray(times)
        print(
            f"{cfg}: avg {times.mean()*1000:.2f} ms | min"
            f" {times.min()*1000:.2f} ms | max {times.max()*1000:.2f} ms |"
            f" {1.0/times.mean():.2f} templates/s"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
