#!/usr/bin/env python3
"""
Trace one float32 Fisher matrix of ``kde_example.cfg`` at 240,000 toy
events (``chip_smoke.TOY_EVENTS`` a category, as ``chip_smoke.py``'s
``events_fp32`` builds it) on one NVIDIA card with ``torch.profiler``, and
split its wall: the host's time, the card's kernels by kind, the busy
share.

Run from the root of a checkout:

    python3 scripts/trace_kde_fisher.py [--out DIR] [--calls N]

It builds the stacked template (``Pipeline(...).compile()``), runs
``get_fisher_matrix`` twice to warm it, times `N` more calls (host clock
around a synchronize), then profiles one. It prints the wall, the device
time of the kernels and their number, that time by kind (the KDE kernels,
the oscillation chain kernels, every other kernel by name), the ops with
the most host time, and the KDE kernels' launches, each line with the
card's name and power limit; ``DIR/trace_kde_fisher.json`` holds the
tables (DIR: ``build/tune`` unless ``--out`` names another).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kind_of(name):
    """The kernel's kind for the split: the port's hand-written kernels by
    name, the rest by the first words of their name."""
    for tag in ("kde_gauss", "osc_chain", "tile_kernel", "tile_multi",
                "reduce_kernel", "sum_kernel", "vjp_kernel", "jvp_kernel"):
        if tag in name:
            return "hand-written: " + tag
    return " ".join(name.replace("(", " ").split()[:2])[:80]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune"))
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    os.environ["PISA_TPU_FTYPE"] = "fp32"
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pisa_tpu_torch.analysis.fisher import get_fisher_matrix
    from pisa_tpu_torch.core.pipeline import Pipeline

    if not torch.cuda.is_available():
        print("trace_kde_fisher.py needs an NVIDIA card", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = card_line()
    ct = Pipeline(cs.toy_config(cs.KDE_CFG, cs.TOY_EVENTS),
                  device="cuda").compile()
    for _ in range(2):
        get_fisher_matrix(ct)
    walls = []
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        get_fisher_matrix(ct)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"kde_example Fisher matrix, float32, {12 * cs.TOY_EVENTS} toy"
          f" events: wall {[round(w * 1e3, 3) for w in walls]} ms"
          f" ({args.calls} calls, median {np.median(walls) * 1e3:.3f})"
          f" [{smi}]")
    cs.reset_kde_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        get_fisher_matrix(ct)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kde = cs.kde_launches()

    def device_us(event):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, attr):
                return float(getattr(event, attr))
        return 0.0

    def on_device(event):
        # the kernels and copies themselves: the ops that launched them
        # carry the same device time
        return str(getattr(event, "device_type", "")).endswith("CUDA")

    events = prof.key_averages()
    kernels = [e for e in events if on_device(e) and device_us(e) > 0]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    kinds = {}
    for e in kernels:
        k = kinds.setdefault(kind_of(e.key), [0.0, 0])
        k[0] += device_us(e) / 1e3
        k[1] += e.count
    host = sorted((e for e in events if not on_device(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:25]
    host_ms = sum(e.self_cpu_time_total for e in events
                  if not on_device(e)) / 1e3
    print(f"profiled call: wall {wall * 1e3:.3f} ms (under the profiler),"
          f" device time {device_ms:.3f} ms in {count} kernels and copies"
          f" ({100 * device_ms / (wall * 1e3):.1f}% busy), host ops' self"
          f" time {host_ms:.3f} ms; KDE launches (sum, vjp, jvp) {kde}"
          f" [{smi}]")
    print("device time by kind (ms, launches):")
    for name, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f}  {n:6d}  {name}")
    print("host self time by op (ms, calls):")
    for e in host:
        print(f"  {e.self_cpu_time_total / 1e3:9.4f}  {e.count:6d}  {e.key}")
    with open(os.path.join(args.out, "trace_kde_fisher.json"), "w") as f:
        json.dump({
            "card": smi, "walls_ms": [w * 1e3 for w in walls],
            "profiled_wall_ms": wall * 1e3, "device_ms": device_ms,
            "kernels": count, "host_self_ms": host_ms, "kde_launches": kde,
            "by_kind": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in kinds.items()},
            "host_top": [{"op": e.key, "self_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
