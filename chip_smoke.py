#!/usr/bin/env python3
"""
Smoke test of the PyTorch/CUDA port (``pisa_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's three CUDA kernels (the oscillation chain, its tangent
and its multitangent) from the sources in the checkout, checks each against
its plain PyTorch version on the card at the flagship's shapes, and drives
the flagship IceCube 3-year pipeline
(``settings/pipeline/IceCube_3y_neutrinos.cfg``: 240k events, 200x200
oscillation grid, 15 free parameters) on the card through its two paths:

- the eager template, ``Pipeline(..., device="cuda").get_outputs()``, in
  float32 and float64, each template compared with the same pipeline run on
  the CPU in float64;
- the fit, ``Pipeline(...).compile().build_objective(data, "mod_chi2")``:
  the analytic ``value_and_grad`` (float64 on the card against the CPU in
  float64, against central finite differences, and with separate tangents
  against the multitangent; float32 against float64), and the bounded
  L-BFGS Asimov fit (``analysis/device_fit.minimize_on_device``) in float32.

It times the kernels (device-only, from a CUDA graph of 200 launches, and
host-inclusive, from back-to-back launches between CUDA events; the
multitangent at K = 3 and K = 6 beside K launches of the tangent), prints
their registers and occupancy, times the gradient by both of its routes
(wall and device time) and the fit, and lists where one gradient waits for
the card. It exits
non-zero on any failed check; the last line of a passing run is
``{"ok": true, "device": {...}}``. With ``--kernels-only`` it stops after
the kernel checks and timings (and prints no status line).

The float64 runs (CPU reference and card) happen in a child process, since
the float type is chosen once per process (``PISA_TPU_FTYPE``); the main
process runs float32, the port's default.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
KERNEL_SOURCE = "pisa_tpu_torch/csrc/osc_chain.cu"
# each kernel's name and the TPU kernel it replaces (file:line)
KERNELS = {
    "osc_chain": "pisa_tpu/ops/osc/pallas_chain.py:562",
    "osc_chain_tangent": "pisa_tpu/ops/osc/pallas_chain.py:584",
    "osc_chain_multitangent": "pisa_tpu/ops/osc/pallas_chain.py:888",
}
FREE_THETA = (1, 2, 5)  # the flagship frees theta13, theta23, dm31

# H100 SXM peaks (NVIDIA data sheet): vector (non-tensor-core) float32 and
# float64 rates, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card (max abs difference of probabilities)
KERNEL_ATOL = {"float64": 1e-10, "float32": 1e-4}
# tangent (and multitangent tangents) vs plain, relative to the largest
# |tangent| of the direction: float64 differs by operation order; float32
# by rounding, which reaches 8.55e-5 on probabilities <= 1 in the primal
TANGENT_RTOL = {"float64": 1e-9, "float32": 1e-3}
# multitangent primal vs the plain primal and the primal kernel
MULTI_PRIMAL_ATOL = {"float64": 1e-10, "float32": 1e-4}
# card template vs CPU float64 template, relative per bin: float64 differs
# only by summation order (atomics, matmul blocking); float32 by rounding,
# judged on bins holding >= 1 expected event
TEMPLATE_RTOL = {"float64": 1e-9, "float32": 1e-4}
MIN_EVENTS_FP32 = 1.0

# value_and_grad of mod_chi2 at the perturbed point (see gradient_point):
# card float64 vs CPU float64, both in float64 up to operation order: value
# relative, gradient entry by entry (rtol, plus atol as a fraction of the
# largest |gradient|)
VG_FP64 = {"value": 1e-9, "grad_rtol": 1e-7, "grad_atol": 1e-9}
# central finite differences of the card float64 objective (h = 1e-5 in
# rescaled units) vs its analytic gradient: the truncation (h^2/6 times the
# third derivative) and the rounding (~eps |f| / h, ~3e-8 here) stay under
# these (rtol, plus atol as a fraction of the largest |gradient|)
FD_STEP = 1e-5
FD_TOL = {"rtol": 1e-4, "atol": 1e-7}
# separate tangent launches vs one multitangent launch per sign, in
# max |difference| / max |gradient|: the same arithmetic, fused differently
TANGENTS_VS_MULTI = {"float64": 1e-10, "float32": 1e-3}
# card float32 vs card float64 on the same data: the float32 template is
# within ~1.5e-6 per bin and the float32 tangents within ~3e-4 of their
# direction's largest, which the metric's (data - template) amplifies
VG_FP32 = {"value": 1e-4, "grad_rtol": 1e-2, "grad_atol": 1e-4}
# the Asimov fit recovers theta23 to this, in rescaled units
# (tests/test_device_fit.py:140)
FIT_TOL = 5e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def param_points(ureg):
    """The three template points, as in tests/test_icecube_3y.py: nominal;
    theta23 and deltam31 moved; opt_eff_overall moved. Each entry: (label,
    changes, whether the oscillation parameters changed)."""
    return [
        ("nominal", {}, True),
        ("theta23+dm31", {"theta23": 42.0 * ureg.degree,
                          "deltam31": 2.3e-3 * ureg.eV**2}, True),
        ("opt_eff_overall", {"opt_eff_overall": 1.1 * ureg.dimensionless},
         False),
    ]


def run_points(pipeline, ureg, chain):
    """get_outputs at each point; returns {label: (hist dict, err dict)} and
    the kernel launches each point made."""
    out, launches = {}, {}
    for label, changes, _ in param_points(ureg):
        for name, value in changes.items():
            pipeline.params[name].value = value
        before = chain.launch_count
        maps = pipeline.get_outputs()
        launches[label] = chain.launch_count - before
        out[label] = (
            {m.name: m.hist for m in maps},
            {m.name: m.error_hist for m in maps},
        )
    return out, launches


def max_rel(ref, got, mask=None):
    import numpy as np

    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    denom = np.where(ref != 0, np.abs(ref), 1.0)
    rel = np.abs(got - ref) / denom
    if mask is not None:
        rel = rel[mask]
    return float(rel.max()) if rel.size else 0.0


def check_template(out, label):
    """The repo's own sanity checks of a flagship template
    (tests/test_icecube_3y.py): 12 finite non-negative maps of 8x8x2 bins, a
    sane expected-event count, numu CC above nue CC, errors present."""
    import numpy as np

    hists, errs = out
    check(len(hists) == 12, f"{label}: {len(hists)} maps, expected 12")
    for name, h in hists.items():
        check(h.shape == (8, 8, 2), f"{label}: {name} shape {h.shape}")
        check(np.all(np.isfinite(h)) and np.all(h >= 0),
              f"{label}: {name} has non-finite or negative bins")
        check(errs[name] is not None and np.all(np.isfinite(errs[name])),
              f"{label}: {name} errors missing or non-finite")
    total = sum(float(h.sum()) for h in hists.values())
    check(1e3 < total < 1e6, f"{label}: total {total} expected events")
    check(hists["numu_cc"].sum() > hists["nue_cc"].sum(),
          f"{label}: numu CC not above nue CC")
    return total


# -- the gradient path: shared by both processes --------------------------------
def launch_counts(chain):
    return (chain.launch_count, chain.tangent_launch_count,
            chain.multitangent_launch_count)


def reset_launch_counts(chain):
    chain.launch_count = 0
    chain.tangent_launch_count = 0
    chain.multitangent_launch_count = 0


def expected_vg_launches(multitangent):
    """(primal, tangent, multitangent) launches of one value_and_grad: the
    two primal launches (nu, nubar) of the forward, then per sign one
    tangent launch per free oscillation parameter, or one multitangent
    launch."""
    if multitangent:
        return (2, 0, 2)
    return (2, 2 * len(FREE_THETA), 0)


def gradient_point(ct):
    """The value_and_grad point: the nominal rescaled values clipped to
    [0.15, 0.85] (tests/test_rate_defer.py:79-94) plus a seeded offset in
    [-0.1, 0.1], clipped again (test_rate_defer.py:97-116), so that the
    objective is away from its minimum at the nominal Asimov data."""
    import numpy as np

    v0 = np.clip(ct.current_rescaled_values(), 0.15, 0.85)
    rng = np.random.RandomState(5)
    return np.clip(v0 + rng.uniform(-0.1, 0.1, v0.size), 0.15, 0.85)


def value_and_grad_counted(pipeline, chain, vg, v, multitangent):
    """One value_and_grad with the backward's tangent route chosen; returns
    the value, the gradient (numpy) and the kernel launches it made."""
    import torch

    stage = pipeline["osc.prob3"]
    default, stage.multitangent = stage.multitangent, multitangent
    try:
        before = launch_counts(chain)
        value, grad = vg(v)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        after = launch_counts(chain)
    finally:
        stage.multitangent = default
    return (float(value), grad.cpu().numpy(),
            tuple(a - b for a, b in zip(after, before)))


def rel_max(got, want):
    """max |got - want| / max |want|."""
    import numpy as np

    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def grad_mismatch(got, want, rtol, atol_fraction):
    """Worst entry of |got - want| / (rtol |want| + atol_fraction max|want|):
    at most 1 when every entry is within its bound."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    allowed = rtol * np.abs(want) + atol_fraction * np.abs(want).max()
    return float((np.abs(got - want) / allowed).max())


def gradient_worker(cpu_pipeline, gpu_pipeline, chain):
    """float64 value_and_grad of mod_chi2 at full width: the CPU and the
    card, the card's central finite differences, and separate tangents
    against the multitangent. Returns arrays for the npz."""
    import numpy as np

    for pipeline in (cpu_pipeline, gpu_pipeline):
        pipeline.params.reset_all()
    cpu_ct = cpu_pipeline.compile()
    data = cpu_ct.get_outputs()  # Asimov data at nominal
    v = gradient_point(cpu_ct)
    _, cpu_vg = cpu_ct.build_objective(data, "mod_chi2")
    # the CPU takes the plain tangents; the one-pass (batched) multitangent
    # is the quicker of the two there, and gives the same gradient
    t0 = time.perf_counter()
    cpu_value, cpu_grad, _ = value_and_grad_counted(
        cpu_pipeline, chain, cpu_vg, v, True)
    cpu_seconds = time.perf_counter() - t0

    ct = gpu_pipeline.compile()
    check(ct.free_names == cpu_ct.free_names, "free params differ")
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    value, grad, launches = value_and_grad_counted(gpu_pipeline, chain, vg,
                                                   v, False)
    value_m, grad_m, launches_m = value_and_grad_counted(gpu_pipeline, chain,
                                                         vg, v, True)
    fd = np.empty_like(grad)
    for i in range(v.size):
        step = np.zeros_like(v)
        step[i] = FD_STEP
        fd[i] = (float(value_fn(v + step)) - float(value_fn(v - step))) / (
            2 * FD_STEP)
    out = {
        "vg|free_names": np.asarray(ct.free_names),
        "vg|v": v,
        "vg|cpu_value": np.asarray(cpu_value),
        "vg|cpu_grad": cpu_grad,
        "vg|cpu_seconds": np.asarray(cpu_seconds),
        "vg|value": np.asarray(value),
        "vg|grad": grad,
        "vg|value_multi": np.asarray(value_m),
        "vg|grad_multi": grad_m,
        "vg|fd": fd,
        "vg|launches": np.asarray(launches),
        "vg|launches_multi": np.asarray(launches_m),
    }
    for m in data:
        out[f"data|{m.name}"] = np.asarray(m.hist)
    return out


# -- the float64 child ---------------------------------------------------------
def reference_worker(path):
    """float64: the CPU reference and the card run at every template point,
    then the gradient phase (gradient_worker); saved to `path` (npz) with the
    card's launch counts."""
    import numpy as np
    import torch

    from pisa_tpu_torch import FTYPE_NAME, ureg
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain

    check(FTYPE_NAME == "fp64", f"reference worker runs {FTYPE_NAME}")
    t0 = time.perf_counter()
    cpu_pipeline = Pipeline(CFG, device="cpu")
    cpu_out, _ = run_points(cpu_pipeline, ureg, chain)
    t_cpu = time.perf_counter() - t0
    gpu_pipeline = Pipeline(CFG, device="cuda")
    chain.launch_count = 0
    gpu_out, launches = run_points(gpu_pipeline, ureg, chain)
    torch.cuda.synchronize()
    arrays = {"cpu_seconds": np.asarray(t_cpu)}
    for label, changes, osc_changed in param_points(ureg):
        check(launches[label] == (2 if osc_changed else 0),
              f"float64 {label}: {launches[label]} kernel launches")
        for tag, out in (("cpu", cpu_out), ("gpu", gpu_out)):
            hists, errs = out[label]
            for name in hists:
                arrays[f"{tag}|{label}|w|{name}"] = hists[name]
                arrays[f"{tag}|{label}|e|{name}"] = errs[name]
        arrays[f"launches|{label}"] = np.asarray(launches[label])
    arrays.update(gradient_worker(cpu_pipeline, gpu_pipeline, chain))
    np.savez(path, **arrays)


# -- the main (float32) process ------------------------------------------------
def device_lines():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda},"
          f" python {sys.version.split()[0]}")
    return smi


def build_kernel(chain):
    """Build (or load) the kernel library; print the compiler's report."""
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        chain.kernel_library()
    print(f"kernel build/load: {time.perf_counter() - t0:.1f} s"
          f" (from {KERNEL_SOURCE}, sm_90a)")
    for line in log.getvalue().splitlines():
        print(f"  {line}")


def flagship_geometry(dtype):
    """The kernel's prepared geometry on the flagship's 200x200 grid with
    the config's PREM-12 Earth model, on the card."""
    from pisa_tpu_torch.config.parser import parse_pipeline_config
    from pisa_tpu_torch.ops.osc.chain import prepare_chain_geometry
    from pisa_tpu_torch.ops.osc.layers import Layers

    config = parse_pipeline_config(CFG)
    settings = config[("osc", "prob3")]
    selector = settings["params"]
    selector.select_params(config["pipeline"]["param_selections"])
    params = {p.name: p for p in selector.params}
    layers = Layers(
        params["earth_model"].value,
        params["detector_depth"].m_as("km"),
        params["prop_height"].m_as("km"),
    )
    layers.setElecFrac(*(params[n].m_as("dimensionless")
                         for n in ("YeI", "YeO", "YeM")))
    binning = settings["calc_mode"]
    grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
    energy = grid[binning.index("true_energy")].ravel()
    layers.calcLayers(grid[binning.index("true_coszen")].ravel())
    shape = (energy.size, layers.max_layers)
    return prepare_chain_geometry(
        energy, layers.density.reshape(shape),
        layers.distance.reshape(shape), dtype=dtype, device="cuda",
    ), params


def flagship_thetas(params):
    """Nominal NuFIT and 3 seeded random theta (the same for every dtype)."""
    import numpy as np

    nominal = [
        params["theta12"].m_as("rad"), params["theta13"].m_as("rad"),
        params["theta23"].m_as("rad"), params["deltacp"].m_as("rad"),
        params["deltam21"].m_as("eV**2"), params["deltam31"].m_as("eV**2"),
    ]
    rng = np.random.RandomState(20261016)
    return [nominal] + [
        [np.radians(rng.uniform(31, 36)), np.radians(rng.uniform(8, 9)),
         np.radians(rng.uniform(38, 52)), np.radians(rng.uniform(0, 360)),
         rng.uniform(7e-5, 8e-5),
         rng.choice([-1, 1]) * rng.uniform(2.3e-3, 2.7e-3)]
        for _ in range(3)
    ]


def pack_and_directions(chain, theta, nubar, dtype):
    """The pack on the card and the 6 columns of its Jacobian in theta (the
    directions the gradient's tangents run along), (6, 57)."""
    import torch

    th = torch.tensor(theta, dtype=torch.float64)
    jac = torch.func.jacfwd(lambda t: chain.theta_to_pvec(t, nubar))(th)
    return (chain.theta_to_pvec(th, nubar).to("cuda", dtype),
            jac.T.contiguous().to("cuda", dtype))


def kernel_bound(chain, geom, k, with_primal):
    """Least time of one launch on the card: operations
    (chain.chain_operations, counted for this geometry's layer steps) over
    the peak rate of the dtype, or bytes (inputs read once: energy, bounds,
    the slab entries the chains reach, the pack and its directions; outputs
    written once) over the memory rate; the larger, and which it is."""
    dname = str(geom["e"].dtype).split(".")[-1]
    size = geom["e"].element_size()
    n = geom["e"].shape[0]
    steps = int((geom["dist"] > 0).sum())
    slab_entries = int(geom["nl"].long().sum())
    per_point, per_step = chain.chain_operations(k)
    ops = n * per_point + steps * per_step
    outputs = 6 * n * (k + (1 if with_primal else 0))
    nbytes = size * (n + 2 * slab_entries + chain.N_PACK * (1 + k)
                     + outputs) + 4 * n
    t_ops = ops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def kernel_vs_plain(chain):
    """Primal kernel vs plain version on the card: flagship geometry, nu and
    nubar, nominal NuFIT and 3 seeded random theta, in float64 and float32.
    Then the kernel's device-only and host-inclusive times, the plain
    version's, and the kernel's resources. Returns the summary per dtype."""
    import torch

    summary = {}
    exact = {}  # float64 plain results, to show the float32 kernel's error
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        worst = vs_exact = 0.0
        for i, theta in enumerate(thetas):
            for nubar in (1, -1):
                pvec = chain.theta_to_pvec(theta, nubar).to("cuda", dtype)
                got = chain.chain_probs(pvec, *args, tiles)
                ref = chain.chain_probs_reference(pvec, *args)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()),
                      f"{dname}: kernel output not finite")
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                if dtype == torch.float64:
                    exact[i, nubar] = ref
                else:
                    vs_exact = max(vs_exact, float(
                        (got.double() - exact[i, nubar]).abs().max()))
        n = geom["e"].shape[0]
        print(f"kernel vs plain, {dname}, N={n}, L={geom['dens'].shape[0]},"
              f" mean chain {float(geom['nl'].double().mean()):.3f},"
              f" max {int(geom['nl'].max())}: max|kernel-plain| = {worst:.3e}"
              f" (bound {KERNEL_ATOL[dname]:g}, 4 theta x 2 signs)")
        check(worst <= KERNEL_ATOL[dname],
              f"{dname}: kernel disagrees with plain version by {worst}")
        if dtype == torch.float32:
            print(f"  float32 kernel vs float64 plain: max abs {vs_exact:.3e}"
                  " (the float32 algorithm's own error)")

        pvec = chain.theta_to_pvec(thetas[0], 1).to("cuda", dtype)
        run = lambda: chain.chain_probs(pvec, *args, tiles)  # noqa: E731
        device_ms = graph_time(run)
        host_ms = cuda_time(run, 200)
        plain_ms = cuda_time(lambda: chain.chain_probs_reference(pvec, *args),
                             10)
        bound = kernel_bound(chain, geom, 0, True)
        print(f"time, osc_chain {dname}, N={n}, {tile_line(tiles)}: kernel"
              f" {device_ms:.5f} ms device-only (CUDA graph), {host_ms:.5f} ms"
              f" with the host's enqueue (CUDA events), plain PyTorch"
              f" {plain_ms:.4f} ms; bound {bound['bound_ms']:.5f} ms by"
              f" {bound['bound_by']} ({bound['ops']} operations,"
              f" {bound['bytes']} bytes)")
        summary[dname] = {"max_abs_err": worst, "ms": device_ms,
                          "host_ms": host_ms, "plain_ms": plain_ms, **bound,
                          **resources(chain, "osc_chain", dtype)}
    return summary


def tangent_vs_plain(chain):
    """Tangent kernel vs plain version (forward-mode derivative of the plain
    primal) on the card: flagship geometry, nu and nubar, nominal and 3
    seeded theta, all 6 pack-Jacobian directions, float64 and float32. The
    error of a direction is max|kernel - plain| over its (2, 3, N) output
    relative to that output's max|plain|. Then the kernel's times and the
    plain version's."""
    import torch

    summary = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        worst_rel = worst_abs = 0.0
        for theta in thetas:
            for nubar in (1, -1):
                pvec, dirs = pack_and_directions(chain, theta, nubar, dtype)
                for d in dirs:
                    got = chain.chain_tangent(pvec, d, *args, tiles)
                    ref = chain.chain_tangent_reference(pvec, d, *args)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{dname}: tangent kernel output not finite")
                    err = float((got - ref).abs().max())
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel,
                                    err / float(ref.abs().max()))
        print(f"tangent kernel vs plain, {dname}: max rel {worst_rel:.3e}"
              f" (bound {TANGENT_RTOL[dname]:g}; 4 theta x 2 signs x 6"
              f" directions), max abs {worst_abs:.3e}")
        check(worst_rel <= TANGENT_RTOL[dname],
              f"{dname}: tangent kernel disagrees with plain by {worst_rel}")
        pvec, dirs = pack_and_directions(chain, thetas[0], 1, dtype)
        d = dirs[2].contiguous()  # theta23
        run = lambda: chain.chain_tangent(pvec, d, *args, tiles)  # noqa: E731
        device_ms = graph_time(run)
        host_ms = cuda_time(run, 200)
        plain_ms = cuda_time(
            lambda: chain.chain_tangent_reference(pvec, d, *args), 5)
        bound = kernel_bound(chain, geom, 1, False)
        print(f"time, osc_chain_tangent {dname}, {tile_line(tiles)}: kernel"
              f" {device_ms:.5f} ms device-only (CUDA graph), {host_ms:.5f}"
              f" ms with enqueue; plain PyTorch {plain_ms:.4f} ms; bound"
              f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
              f" ({bound['ops']} operations, {bound['bytes']} bytes)")
        summary[dname] = {
            "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "ms": device_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            **bound, **resources(chain, "osc_chain_tangent", dtype)}
    return summary


def multitangent_vs_plain(chain):
    """Multitangent kernel at K = 3 (the flagship's free theta13, theta23,
    dm31), K = 1 and K = 6 on the card against its plain version and
    against the primal kernel and K launches of the tangent kernel:
    flagship geometry, nu and nubar, nominal and seeded theta (4 at K = 3, 2
    at K = 1 and 6), float64 and float32. Then, at K = 3 and K = 6, its
    device-only and host-inclusive times beside K tangent launches', and
    every instance's resources. Returns the K = 3 summary per dtype."""
    import torch

    summary = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        geom, params = flagship_geometry(dtype)
        thetas = flagship_thetas(params)
        args = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        tiles = geom["tiles"]
        for k in (3, 1, 6):
            pick = list(FREE_THETA) if k == 3 else list(range(k))
            errs = {"plain_p": 0.0, "plain_t": 0.0, "plain_t_abs": 0.0,
                    "kern_p": 0.0, "kern_t": 0.0}
            for theta in thetas if k == 3 else thetas[:2]:
                for nubar in (1, -1):
                    pvec, dirs = pack_and_directions(chain, theta, nubar,
                                                     dtype)
                    dpvecs = dirs[pick].contiguous()
                    out, dout = chain.chain_multitangent(pvec, dpvecs, *args,
                                                         tiles)
                    ref_p, ref_t = chain.chain_multitangent_reference(
                        pvec, dpvecs, *args)
                    kern_p = chain.chain_probs(pvec, *args, tiles)
                    kern_t = torch.stack(
                        [chain.chain_tangent(pvec, d, *args, tiles)
                         for d in dpvecs])
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all())
                          and bool(torch.isfinite(dout).all()),
                          f"{dname}: multitangent kernel output not finite")
                    scale = ref_t.abs().amax(dim=(1, 2, 3), keepdim=True)
                    for key, value in (
                        ("plain_p", (out - ref_p).abs().max()),
                        ("plain_t", ((dout - ref_t).abs() / scale).max()),
                        ("plain_t_abs", (dout - ref_t).abs().max()),
                        ("kern_p", (out - kern_p).abs().max()),
                        ("kern_t", ((dout - kern_t).abs() / scale).max()),
                    ):
                        errs[key] = max(errs[key], float(value))
            print(f"multitangent kernel (K={k}), {dname}: primal vs plain"
                  f" {errs['plain_p']:.3e}, vs primal kernel"
                  f" {errs['kern_p']:.3e} (bound {MULTI_PRIMAL_ATOL[dname]:g}"
                  f" abs); tangents vs plain {errs['plain_t']:.3e}, vs"
                  f" tangent kernel {errs['kern_t']:.3e} (bound"
                  f" {TANGENT_RTOL[dname]:g} rel);"
                  f" {4 if k == 3 else 2} theta x 2 signs")
            check(max(errs["plain_p"], errs["kern_p"])
                  <= MULTI_PRIMAL_ATOL[dname],
                  f"{dname}: K={k} multitangent primal off by {errs}")
            check(max(errs["plain_t"], errs["kern_t"]) <= TANGENT_RTOL[dname],
                  f"{dname}: K={k} multitangent tangents off by {errs}")
            if k == 1:
                continue
            pvec, dirs = pack_and_directions(chain, thetas[0], 1, dtype)
            dpvecs = dirs[pick].contiguous()
            run = lambda: chain.chain_multitangent(  # noqa: E731
                pvec, dpvecs, *args, tiles)
            separate = lambda: [  # noqa: E731
                chain.chain_tangent(pvec, d, *args, tiles) for d in dpvecs]
            # in turns: K tangents, multitangent, multitangent, K tangents
            turns = {"multi": [], "separate": []}
            for label in ("separate", "multi", "multi", "separate"):
                fn = run if label == "multi" else separate
                turns[label].append((graph_time(fn), cuda_time(fn, 200)))
            device_ms, host_ms = (min(t[i] for t in turns["multi"])
                                  for i in (0, 1))
            sep_ms, sep_host_ms = (min(t[i] for t in turns["separate"])
                                   for i in (0, 1))
            plain_ms = cuda_time(
                lambda: chain.chain_multitangent_reference(pvec, dpvecs,
                                                           *args), 3)
            bound = kernel_bound(chain, geom, k, True)
            print(f"time, osc_chain_multitangent {dname} (K={k}),"
                  f" {tile_line(tiles)}: kernel {device_ms:.5f} ms"
                  f" device-only (CUDA graph), {host_ms:.5f} ms with enqueue;"
                  f" {k} tangent launches {sep_ms:.5f} ms device-only,"
                  f" {sep_host_ms:.5f} ms with enqueue (the better of two"
                  f" turns each); plain PyTorch {plain_ms:.4f} ms; bound"
                  f" {bound['bound_ms']:.5f} ms by {bound['bound_by']}"
                  f" ({bound['ops']} operations, {bound['bytes']} bytes):"
                  f" {100 * bound['bound_ms'] / device_ms:.1f}% of it")
            if k == 3:
                summary[dname] = {
                    "max_abs_err": max(errs["plain_p"], errs["plain_t_abs"]),
                    "max_rel_err": errs["plain_t"], "ms": device_ms,
                    "host_ms": host_ms, "plain_ms": plain_ms,
                    "tangents_ms": sep_ms, **bound}
        for k in range(1, chain.MAX_TANGENTS + 1):
            a = resources(chain, "osc_chain_multitangent", dtype, k)
            if k == 3:
                summary[dname].update(a)
    return summary


def tile_line(tiles):
    t = tiles["tile"]
    return (f"{t.shape[0]} tiles of <= {int(t[:, 3].max())} steps"
            f" ({tiles['rho'].shape[0]} steps)")


def resources(chain, name, dtype, k=1):
    """Print and return a kernel's registers, local memory, shared memory,
    block size and resident blocks per SM (CUDA's occupancy calculator); the
    multitangent's for K = k, with the directions a thread holds in its
    phases 1 and 2."""
    dname = str(dtype).split(".")[-1]
    a = chain.kernel_attributes(name, dtype, k)
    tag = ""
    if name == "osc_chain_multitangent":
        tag = f" K={k} (c1={a['c1']}, c2={a['c2']})"
    print(f"resources, {name} {dname}{tag}: {a['registers']} registers,"
          f" {a['local_bytes']} B local memory (stack frame and spills) per"
          f" thread,"
          f" {a['shared_bytes']} B shared per block, {a['threads']}"
          f" threads per block, {a['blocks_per_sm']} resident blocks per SM"
          f" ({a['blocks_per_sm'] * a['threads'] // 32} of 64 warps)")
    return a


def graph_time(fn, launches=200, replays=5):
    """Device-only time of one fn() call: `launches` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so the host's
    enqueue is outside the timed region."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (launches * replays)
    del graph
    return ms


def cuda_time(fn, reps):
    """Time of one fn() call over `reps` back-to-back calls between CUDA
    events: the device's time, or the host's enqueue where that is
    slower."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(ref, got, label, dname, n_events_mask):
    import numpy as np

    worst_w = worst_e = 0.0
    for name, ref_w in ref[0].items():
        mask = (np.abs(ref_w) >= MIN_EVENTS_FP32) if n_events_mask else None
        worst_w = max(worst_w, max_rel(ref_w, got[0][name], mask))
        worst_e = max(worst_e, max_rel(ref[1][name], got[1][name], mask))
    scope = "bins >= 1 event" if n_events_mask else "all bins"
    print(f"template {label}, card {dname} vs CPU float64 ({scope}): max rel"
          f" weights {worst_w:.3e}, errors {worst_e:.3e}"
          f" (bound {TEMPLATE_RTOL[dname]:g})")
    check(worst_w <= TEMPLATE_RTOL[dname] and worst_e <= TEMPLATE_RTOL[dname],
          f"{label}: card {dname} template off the CPU reference")


def check_gradient_fp64(ref):
    """Phase checks of the float64 value_and_grad (run in the child)."""
    free_names = [str(n) for n in ref["vg|free_names"]]
    value, grad = float(ref["vg|value"]), ref["vg|grad"]
    cpu_value, cpu_grad = float(ref["vg|cpu_value"]), ref["vg|cpu_grad"]
    print(f"value_and_grad, float64, full width, {len(free_names)} free"
          f" params: card {value!r} vs CPU {cpu_value!r}")
    for name, a, b, f in zip(free_names, grad, cpu_grad, ref["vg|fd"]):
        print(f"  d/d {name:22s} card {a: .10e}  CPU {b: .10e}"
              f"  central FD {f: .10e}")
    value_err = abs(value - cpu_value) / abs(cpu_value)
    grad_err = grad_mismatch(grad, cpu_grad, VG_FP64["grad_rtol"],
                             VG_FP64["grad_atol"])
    fd_err = grad_mismatch(ref["vg|fd"], grad, FD_TOL["rtol"], FD_TOL["atol"])
    multi_err = rel_max(ref["vg|grad_multi"], grad)
    print(f"  card vs CPU: value rel {value_err:.3e} (bound"
          f" {VG_FP64['value']:g}); gradient {rel_max(grad, cpu_grad):.3e} of"
          f" max|g|, worst entry at {grad_err:.3e} of its bound (rtol"
          f" {VG_FP64['grad_rtol']:g}, atol {VG_FP64['grad_atol']:g} max|g|);"
          f" CPU value_and_grad {float(ref['vg|cpu_seconds']):.1f} s")
    print(f"  central FD (h={FD_STEP:g}) vs card: {rel_max(ref['vg|fd'], grad):.3e}"
          f" of max|g|, worst entry at {fd_err:.3e} of its bound")
    print(f"  separate tangents vs multitangent: {multi_err:.3e} of max|g|"
          f" (bound {TANGENTS_VS_MULTI['float64']:g}); values"
          f" {value!r} / {float(ref['vg|value_multi'])!r}")
    launches = tuple(int(x) for x in ref["vg|launches"])
    launches_m = tuple(int(x) for x in ref["vg|launches_multi"])
    print(f"  launches (primal, tangent, multitangent) per value_and_grad:"
          f" {launches} separate, {launches_m} multitangent")
    check(value_err <= VG_FP64["value"], "float64 card value off the CPU's")
    check(grad_err <= 1.0, "float64 card gradient off the CPU's")
    check(fd_err <= 1.0, "float64 gradient off the finite differences")
    check(multi_err <= TANGENTS_VS_MULTI["float64"],
          "float64 multitangent gradient off the separate tangents'")
    check(launches == expected_vg_launches(False),
          f"float64 value_and_grad launches {launches}")
    check(launches_m == expected_vg_launches(True),
          f"float64 multitangent value_and_grad launches {launches_m}")


def median_wall(fn, reps):
    import numpy as np
    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), float(min(walls))


def count_host_syncs(fn, sources=None):
    """fn() with torch's CUDA sync debug mode warning at every operation
    that waits for the card (a value read back, a copy to the host); returns
    the number of such waits and fn's result. With `sources` (a dict), also
    counts the waits there by the source line Python gives each warning
    ("file:line"; a wait inside the backward pass is reported at the line
    that started it)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sources is not None:
        for w in syncs:
            where = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sources[where] = sources.get(where, 0) + 1
    return len(syncs), result


def print_host_sync_sources(label, fn):
    """One fn() under the sync debug mode: its waits for the card, grouped
    by source line, most frequent first."""
    import linecache

    sources = {}
    syncs, _ = count_host_syncs(fn, sources)
    print(f"host syncs of one {label}: {syncs}, by source line:")
    for where, count in sorted(sources.items(), key=lambda x: -x[1]):
        path, line = where.rsplit(":", 1)
        text = linecache.getline(os.path.join(ROOT, path), int(line)).strip()
        print(f"  {count:4d}x  {where}  {text[:80]}")


# profiler entries that copy to the host or wait for the card
_SYNC_KEYS = ("Memcpy DtoH", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync",
              "aten::_local_scalar_dense", "aten::item", "aten::_to_copy",
              "ToCopyBackward")


def print_host_copy_ops(label, fn):
    """One fn() under torch.profiler: the calls of the operators, autograd
    nodes and runtime functions that copy to the host or wait for the card
    (the sync debug mode reports every wait inside the backward pass at the
    one line that started it; this names the nodes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"copies to the host and waits in one {label} (torch.profiler):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.count):
        if any(k in e.key for k in _SYNC_KEYS):
            print(f"  {e.count:4d}x  {e.key[:90]}")


def profile_device_busy(fn):
    """torch.profiler over one call: its wall, the device time of the
    kernels it ran, and the ops with the most device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(event):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, attr):
                return float(getattr(event, attr))
        return 0.0

    events = prof.key_averages()
    total_us = sum(device_us(e) for e in events)
    top = sorted(events, key=device_us, reverse=True)[:8]
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    return (wall, total_us / 1e3,
            [(e.key, device_us(e) / 1e3, e.count)
             for e in top if device_us(e) > 0],
            [(e.key, e.self_cpu_time_total / 1e3, e.count)
             for e in top_host])


def gradient_and_fit_fp32(pipeline, chain, ref, smi):
    """The slice's main path in float32 on the card: compile, value_and_grad
    (separate tangents, then the multitangent), the Asimov fit; checks
    against the float64 card run; then times. Returns the launch counts of
    the main path and the timings."""
    import numpy as np
    import torch

    from pisa_tpu_torch.analysis.device_fit import minimize_on_device

    pipeline.params.reset_all()
    free_names = [str(n) for n in ref["vg|free_names"]]
    data = {k.split("|", 1)[1]: v for k, v in ref.items()
            if k.startswith("data|")}
    v = ref["vg|v"]
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts from 0 to here ...
    reset_launch_counts(chain)
    t0 = time.perf_counter()
    ct = pipeline.compile()
    compile_s = time.perf_counter() - t0
    check(ct.free_names == free_names, "float32 free params differ")
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    value, grad, launches = value_and_grad_counted(pipeline, chain, vg, v,
                                                   False)
    value_m, grad_m, launches_m = value_and_grad_counted(pipeline, chain, vg,
                                                         v, True)
    v0 = ct.current_rescaled_values()
    asimov = ct.get_outputs(v0)
    fit_value_fn, _ = ct.build_objective(asimov, "mod_chi2")
    i23 = ct.free_names.index("theta23")
    x0 = v0.copy()
    x0[i23] = min(0.95, x0[i23] + 0.10)
    los, his = ct._current_bounds()
    t0 = time.perf_counter()
    fit = minimize_on_device(fit_value_fn.raw, x0, los, his)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    main_path = launch_counts(chain)
    # ... and read here.

    value64, grad64 = float(ref["vg|value"]), ref["vg|grad"]
    value_err = abs(value - value64) / abs(value64)
    grad_err = grad_mismatch(grad, grad64, VG_FP32["grad_rtol"],
                             VG_FP32["grad_atol"])
    multi_err = rel_max(grad_m, grad)
    print(f"value_and_grad, float32 card vs float64 card: value {value!r} vs"
          f" {value64!r} (rel {value_err:.3e}, bound {VG_FP32['value']:g});"
          f" gradient {rel_max(grad, grad64):.3e} of max|g|, worst entry at"
          f" {grad_err:.3e} of its bound (rtol {VG_FP32['grad_rtol']:g}, atol"
          f" {VG_FP32['grad_atol']:g} max|g|)")
    for name, a, b in zip(free_names, grad, grad64):
        print(f"  d/d {name:22s} float32 {a: .6e}  float64 {b: .6e}"
              f"  rel {abs(a - b) / max(abs(b), 1e-300):.2e}")
    print(f"  separate tangents vs multitangent (float32): {multi_err:.3e} of"
          f" max|g| (bound {TANGENTS_VS_MULTI['float32']:g})")
    print(f"  launches (primal, tangent, multitangent) per value_and_grad:"
          f" {launches} separate, {launches_m} multitangent")
    check(value_err <= VG_FP32["value"], "float32 value off float64")
    check(grad_err <= 1.0, "float32 gradient off float64")
    check(multi_err <= TANGENTS_VS_MULTI["float32"],
          "float32 multitangent gradient off the separate tangents'")
    check(launches == expected_vg_launches(False),
          f"float32 value_and_grad launches {launches}")
    check(launches_m == expected_vg_launches(True),
          f"float32 multitangent value_and_grad launches {launches_m}")

    moved = float(fit["x"][i23] - v0[i23])
    print(f"Asimov fit, float32 on the card, from theta23 +0.10 rescaled:"
          f" nit {fit['nit']}, nfev {fit['nfev']}, fun {fit['fun']!r},"
          f" theta23 off by {moved:.3e}"
          f" rescaled (bound {FIT_TOL:g}), largest param offset"
          f" {float(np.abs(fit['x'] - v0).max()):.3e}; wall {fit_s:.3f} s"
          f" [{smi}]")
    check(np.isfinite(fit["fun"]) and abs(moved) <= FIT_TOL,
          "the Asimov fit did not recover theta23")
    print(f"main path (compile, 2 value_and_grad, fit) launches: primal"
          f" {main_path[0]}, tangent {main_path[1]}, multitangent"
          f" {main_path[2]}; compile {compile_s:.3f} s")
    check(all(n > 0 for n in main_path), "a kernel of the path never ran")

    # -- timings and host syncs, not counted
    times = {"compile_s": compile_s, "fit_s": fit_s, "fit_nit": fit["nit"]}
    syncs, again = count_host_syncs(
        lambda: minimize_on_device(fit_value_fn.raw, x0, los, his))
    print(f"host syncs of the fit (torch.cuda sync debug mode, a second run):"
          f" {syncs} over {again['nit']} iterations and {again['nfev']}"
          f" evaluations ({syncs / max(again['nit'], 1):.1f} per iteration)")
    print_host_sync_sources("float32 value (forward only)",
                            lambda: value_fn(v))
    print_host_sync_sources("float32 value_and_grad", lambda: vg(v))
    print_host_copy_ops("float32 value_and_grad", lambda: vg(v))
    stage = pipeline["osc.prob3"]
    default = stage.multitangent
    routes = (("value_and_grad separate tangents", False),
              ("value_and_grad multitangent", True))
    device_ms = {label: [] for label, _ in routes}
    for label, multi in routes:
        stage.multitangent = multi
        vg(v)
        times[label] = median_wall(lambda: vg(v), 10)
    # one profiled call per turn: separate, multitangent, multitangent,
    # separate
    for label, multi in routes + routes[::-1]:
        stage.multitangent = multi
        device_ms[label].append(profile_device_busy(lambda: vg(v))[1])
    stage.multitangent = default
    value_fn(v)
    times["value"] = median_wall(lambda: value_fn(v), 10)
    for label in ("value", *device_ms):
        med, low = times[label]
        print(f"float32 {label} wall (10 calls): median {med * 1e3:.2f} ms,"
              f" min {low * 1e3:.2f} ms [{smi}]")
    for label, ms in device_ms.items():
        print(f"float32 {label}: device time (torch.profiler, one call a"
              f" turn) {' / '.join(f'{x:.4f}' for x in ms)} ms [{smi}]")
    default_label = routes[1 if default else 0][0]
    print(f"prob3's default route: {default_label}")
    wall, busy_ms, top, top_host = profile_device_busy(lambda: vg(v))
    times["busy"] = busy_ms / (wall * 1e3)
    print(f"torch.profiler, one float32 value_and_grad (the default route):"
          f" wall {wall * 1e3:.2f}"
          f" ms, device time {busy_ms:.3f} ms, device busy"
          f" {100 * times['busy']:.1f}% (of the unprofiled median:"
          f" {100 * busy_ms / (times[default_label][0] * 1e3):.1f}%)"
          f" [{smi}]")
    print("  most device time:")
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    print("  most host time (self, under the profiler):")
    for key, ms, count in top_host:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    print(f"torch.cuda.max_memory_allocated (float32 compile, gradient, fit):"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
    return main_path, times


def print_kernel_times(kernels, smi):
    for name, k in kernels.items():
        for dname, t in k.items():
            print(f"kernel {name} {dname}: {t['ms']:.5f} ms device-only,"
                  f" {t['host_ms']:.5f} ms with enqueue, plain"
                  f" {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by"
                  f" {t['bound_by']}; {t['registers']} registers,"
                  f" {t['blocks_per_sm']} blocks of {t['threads']} per SM"
                  f" [{smi}]")


def main(kernels_only=False):
    if not os.path.isdir(os.path.join(ROOT, "pisa_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository"
              " (pisa_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    os.environ["PISA_TPU_FTYPE"] = "fp32"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one NVIDIA card",
              file=sys.stderr)
        return 1

    from pisa_tpu_torch import ureg
    from pisa_tpu_torch.core.pipeline import Pipeline
    from pisa_tpu_torch.ops.osc import chain

    smi = device_lines()
    build_kernel(chain)
    kernels = {
        "osc_chain": kernel_vs_plain(chain),
        "osc_chain_tangent": tangent_vs_plain(chain),
        "osc_chain_multitangent": multitangent_vs_plain(chain),
    }
    print_kernel_times(kernels, smi)
    if kernels_only:
        return 0

    # float64: CPU reference and card run, in a child process
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, PISA_TPU_FTYPE="fp64")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--reference-worker", path], env=env, check=True)
        print(f"float64 child (CPU reference + card run):"
              f" {time.perf_counter() - t0:.1f} s")
        with np.load(path) as f:
            ref = {k: f[k] for k in f.files}
    print(f"CPU float64 reference, 3 templates: {float(ref['cpu_seconds']):.2f}"
          " s")

    def unpack(tag, label):
        w = {k.split("|")[3]: v for k, v in ref.items()
             if k.startswith(f"{tag}|{label}|w|")}
        e = {k.split("|")[3]: v for k, v in ref.items()
             if k.startswith(f"{tag}|{label}|e|")}
        return w, e

    for label, _, _ in param_points(ureg):
        cpu = unpack("cpu", label)
        check_template(cpu, f"CPU float64 {label}")
        check_template(unpack("gpu", label), f"card float64 {label}")
        compare(cpu, unpack("gpu", label), label, "float64", False)
        print(f"float64 card {label}: {int(ref[f'launches|{label}'])} kernel"
              " launches")
    check_gradient_fp64(ref)

    # float32, the eager template path on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipeline = Pipeline(CFG, device="cuda")
    torch.cuda.synchronize()
    print(f"float32 Pipeline(...) setup on the card:"
          f" {time.perf_counter() - t0:.2f} s")
    reset_launch_counts(chain)
    out, launches = run_points(pipeline, ureg, chain)
    eager_launches = launch_counts(chain)
    torch.cuda.synchronize()
    for label, _, osc_changed in param_points(ureg):
        total = check_template(out[label], f"card float32 {label}")
        compare(unpack("cpu", label), out[label], label, "float32", True)
        print(f"float32 card {label}: {total:.3f} expected events,"
              f" {launches[label]} kernel launches")
        check(launches[label] == (2 if osc_changed else 0),
              f"float32 {label}: {launches[label]} kernel launches")
    check(eager_launches == (4, 0, 0),
          f"the eager path's launches {eager_launches}")

    # get_outputs wall time: with an oscillation recompute, and cached
    walls = {"recompute": [], "cached": []}
    for i in range(10):
        pipeline.params["theta23"].value = (42.0 + 0.1 * i) * ureg.degree
        t0 = time.perf_counter()
        pipeline.get_outputs()
        torch.cuda.synchronize()
        walls["recompute"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        pipeline.get_outputs()
        torch.cuda.synchronize()
        walls["cached"].append(time.perf_counter() - t0)
    for kind, ts in walls.items():
        print(f"float32 get_outputs wall ({kind}, 10 runs): median"
              f" {np.median(ts) * 1e3:.2f} ms, min {min(ts) * 1e3:.2f} ms"
              f" [{smi}]")
    print(f"torch.cuda.max_memory_allocated (float32 pipeline):"
          f" {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")

    # float32, the gradient and fit path on the card (the slice's main path)
    main_path, _ = gradient_and_fit_fp32(pipeline, chain, ref, smi)

    print_kernel_times(kernels, smi)
    lines = []
    for (name, replaces), launches in zip(KERNELS.items(), main_path):
        k = kernels[name]["float32"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
            "dtype": "float32",
            "max_rel_err": k.get("max_rel_err"),
            "host_ms": k["host_ms"],
            "registers": k["registers"],
            "local_bytes": k["local_bytes"],
            "threads": k["threads"],
            "blocks_per_sm": k["blocks_per_sm"],
        })
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference-worker":
        sys.path.insert(0, ROOT)
        os.chdir(ROOT)
        reference_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels-only"]))
