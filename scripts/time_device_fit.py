#!/usr/bin/env python3
"""
Time the flagship's ``device`` fit on one NVIDIA card, float32: the fit
loop's cost per objective evaluation.

    python3 scripts/time_device_fit.py [--repeats N]

It builds the flagship (``settings/pipeline/IceCube_3y_neutrinos.cfg``) as a
``DistributionMaker`` on the card, takes its Asimov template at nominal as
the data, moves theta23 by +0.10 rescaled and fits it back with
``Analysis().fit_recursively(..., "device")``: once to build and capture,
then `repeats` times timed. Beside each fit it times the captured objective's
``value_and_grad`` alone (CUDA events around 20 back-to-back calls), so that
the fit's wall per evaluation splits into the objective and the loop's own
work (the L-BFGS and line-search state, the flag read). Prints one line per
fit and, last, one JSON object with the medians, beside the card's name and
power limit as ``nvidia-smi`` gives them.

It imports ``pisa_tpu_torch`` from ``sys.path``: run it from the root of a
checkout (``PYTHONPATH=.``), or point ``PYTHONPATH`` at another checkout to
time that one's fit loop with the same script.
"""

import argparse
import json
import os
import statistics
import subprocess
import time

CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    os.environ["PISA_TPU_FTYPE"] = "fp32"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs one card")
    import pisa_tpu_torch
    from pisa_tpu_torch.analysis.analysis import Analysis, BasicAnalysis
    from pisa_tpu_torch.core.distribution_maker import DistributionMaker

    smi = card_line()
    print(f"pisa_tpu_torch from {os.path.dirname(pisa_tpu_torch.__file__)};"
          f" {smi}")
    dm = DistributionMaker([CFG], device="cuda")
    data = dm.get_outputs(return_sum=True)
    truth = dm.params["theta23"]._rescaled_value

    def fit():
        dm.reset_free()
        dm.params["theta23"]._rescaled_value = min(0.95, truth + 0.10)
        result = Analysis().fit_recursively(data, dm, "mod_chi2", None,
                                            "device", {}, None)
        torch.cuda.synchronize()
        return result

    t0 = time.perf_counter()
    fit()
    print(f"first fit (set-up and capture): {time.perf_counter() - t0:.3f} s")
    cd = list(BasicAnalysis._compiled_cache.values())[-1]
    _, vg = cd.build_objective(data, "mod_chi2")
    vec = torch.as_tensor(cd.current_rescaled_values(), device="cuda")
    vg(vec)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    rows = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        result = fit()
        wall = time.perf_counter() - t0
        start.record()
        for _ in range(20):
            vg(vec)
        end.record()
        end.synchronize()
        vg_ms = start.elapsed_time(end) / 20
        meta = result.minimizer_metadata
        per_eval = wall / meta["nfev"] * 1e3
        rows.append({"wall_s": wall, "nit": meta["nit"],
                     "nfev": meta["nfev"], "ms_per_evaluation": per_eval,
                     "vg_ms": vg_ms, "loop_ms_per_evaluation":
                     per_eval - vg_ms})
        print(f"fit {i}: wall {wall:.4f} s, nit {meta['nit']}, nfev"
              f" {meta['nfev']}, {per_eval:.4f} ms per evaluation, captured"
              f" value_and_grad {vg_ms:.4f} ms back to back, so the loop"
              f" {per_eval - vg_ms:.4f} ms per evaluation [{smi}]")
    print(json.dumps({
        "card": smi,
        "package": os.path.dirname(pisa_tpu_torch.__file__),
        **{key: statistics.median(r[key] for r in rows)
           for key in rows[0]},
    }))


if __name__ == "__main__":
    main()
