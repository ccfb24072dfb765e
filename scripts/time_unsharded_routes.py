#!/usr/bin/env python3
"""
Time two unsharded paths on one NVIDIA card, float32, so that two checkouts
can be compared in one session on one card: the flagship's captured
``value_and_grad`` (whose histogram stage takes the rate-deferred route that
a sharded template shares) and toy_fit_example's map-to-map resampling,
laned and unlaned.

    python3 scripts/time_unsharded_routes.py [--reps N]

- The flagship (``settings/pipeline/IceCube_3y_neutrinos.cfg``, 240k events,
  the 200x200 calc grid, 15 free) compiled and its mod_chi2 value_and_grad
  captured at ``chip_smoke.py``'s gradient point against the Asimov data at
  nominal: the wall of one call with its read-back (median and min of
  `reps`), the device time and kernels of one replay (``torch.profiler``),
  and the value and gradient themselves, so that two checkouts' can be held
  bit for bit.
- toy_fit_example with prob3 computed on a 200x200 grid and applied on its
  calc grid (``chip_smoke.py:resampled_toy_config``), per container: one
  evaluation of 4 lanes and 4 unlaned evaluations, each wall the median and
  min of `reps`.

Prints the card's name and power limit as ``nvidia-smi`` gives them, then,
last, one JSON object of the numbers. It imports ``pisa_tpu_torch`` from
``sys.path`` and reads its settings from the working directory: run it from
the root of a checkout with ``PYTHONPATH=.``, and from another checkout's
root, with ``PYTHONPATH=.`` there, to time that one with the same script.
"""

import argparse
import json
import os
import subprocess
import time

CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
TOY = "settings/pipeline/toy_fit_example.cfg"
GRID_BINS = 200
LANES = 4
SEED = 0


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def walls(fn, reps):
    """(median, min) wall of `fn` in ms, each call waited for."""
    import numpy as np
    import torch

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), float(min(out))


def device_time(fn):
    """(device ms, kernels and copies) of one call of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    on_device = [e for e in events if str(getattr(e, "device_type", ""))
                 .endswith("CUDA")]
    return (sum(device_us(e) for e in events) / 1e3,
            int(sum(e.count for e in on_device)))


def flagship(reps):
    import numpy as np
    import torch

    from pisa_tpu_torch.core.pipeline import Pipeline

    ct = Pipeline(CFG, device="cuda").compile()
    data = ct.get_outputs(ct.current_rescaled_values())
    v0 = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    v = np.clip(v0 + np.random.RandomState(5).uniform(-0.1, 0.1, v0.size),
                0.15, 0.85)
    value_fn, vg = ct.build_objective(data, "mod_chi2")

    def call():
        value, grad = vg(v)
        return torch.cat([value.reshape(1), grad]).cpu().numpy()

    got = call()
    median, least = walls(call, reps)
    program = value_fn.program
    bounds = ct._device_bounds()
    vec = torch.as_tensor(v, device="cuda")
    ms, kernels = device_time(lambda: program.value_and_grad(vec, *bounds))
    return {"vg_ms": median, "vg_min_ms": least, "replay_device_ms": ms,
            "replay_kernels": kernels,
            "value_and_grad": [float(x) for x in got]}


def resampled_toy(reps):
    import numpy as np
    import torch

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.core import binning
    from pisa_tpu_torch.core.pipeline import Pipeline

    cfg = parse_pipeline_config(TOY)
    cfg[("osc", "prob3")]["calc_mode"] = binning.MultiDimBinning([
        binning.OneDimBinning("true_energy", num_bins=GRID_BINS, is_log=True,
                              domain=[1, 1000] * ureg.GeV),
        binning.OneDimBinning("true_coszen", num_bins=GRID_BINS,
                              is_lin=True, domain=[-1, 1]),
    ], name="osc_grid")
    ct = Pipeline(cfg, device="cuda").compile(stack=False)
    x0 = ct.current_rescaled_values()
    vecs = np.clip(x0 + np.random.RandomState(SEED).uniform(
        -0.05, 0.05, (LANES, x0.size)), 0, 1)
    laned_vec = torch.as_tensor(vecs, device="cuda")
    single_vecs = [torch.as_tensor(v, device="cuda") for v in vecs]

    @torch.no_grad()
    def laned():
        ct._evaluate(ct._magnitudes_from_rescaled(laned_vec), lanes=LANES)

    @torch.no_grad()
    def unlaned():
        for v in single_vecs:
            ct._evaluate(ct._magnitudes_from_rescaled(v))

    laned()
    unlaned()
    laned_ms, laned_min = walls(laned, reps)
    single_ms, single_min = walls(unlaned, reps)
    return {"laned_ms": laned_ms, "laned_min_ms": laned_min,
            "unlaned_ms": single_ms, "unlaned_min_ms": single_min}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    os.environ["PISA_TPU_FTYPE"] = "fp32"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs one card")
    import pisa_tpu_torch

    smi = card_line()
    print(f"pisa_tpu_torch from {os.path.dirname(pisa_tpu_torch.__file__)};"
          f" {smi}")
    out = {"card": smi}
    t0 = time.perf_counter()
    out["flagship"] = flagship(args.reps)
    out["resampled_toy"] = resampled_toy(args.reps)
    out["wall_s"] = time.perf_counter() - t0
    print(f"flagship captured value_and_grad {out['flagship']['vg_ms']:.3f}"
          f" ms (min {out['flagship']['vg_min_ms']:.3f}), one replay"
          f" {out['flagship']['replay_kernels']} kernels"
          f" {out['flagship']['replay_device_ms']:.3f} ms; resampled toy: 4"
          f" lanes {out['resampled_toy']['laned_ms']:.3f} ms, 4 unlaned"
          f" {out['resampled_toy']['unlaned_ms']:.3f} ms [{smi}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
