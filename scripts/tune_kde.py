#!/usr/bin/env python3
"""
Tune the register tiles of the KDE kernels of ``pisa_tpu_torch``
(``csrc/kde_gauss.cu``: ``sum_kernel`` and ``vjp_kernel``) on one NVIDIA
card, and time them beside an earlier source in the same process.

Run from the root of a checkout:

    python3 scripts/tune_kde.py [--parent-source FILE.cu] [--out DIR]
                                [--shapes R:T,R:T,...]

Each build sets the outputs per thread (R) and the threads per block (T)
of both kernels (``-DKDE_SUM_R``, ``-DKDE_SUM_THREADS``, ``-DKDE_VJP_R``,
``-DKDE_VJP_THREADS``); the builds run in parallel. For each build, at
kde_example's shapes (``chip_smoke.kde_inputs``: 24 channels of 20,000
samples, the pilot at the samples and the 1,320-point grid) in the dense
case (every sample live) and the live case (the PID channels' live counts
of ``chip_smoke.kde_live_counts``), in float32, the script checks both
kernels against their float32 plain versions (``chip_smoke.
KDE_KERNEL_RTOL``), reads registers, local memory and resident blocks, and
times each device-only (a CUDA graph of 20 launches, 3 replays) at the
wrapper's split count (``ops/kde.py:launch_splits``), at one split and at
twice the wrapper's. The build as shipped is timed in float64 as well.
With ``--parent-source``, an earlier source's sum and vjp (the signature
without live counts: ``(x, p, p_bstride, ih, il2, c, out, B, D, N, M,
stream)``) are timed on the dense inputs first and last, around the
builds.

It prints one line per measurement (with the card's name and power limit)
and the best shape per kernel and case, and writes everything to
``DIR/tune_kde.json`` (DIR: ``build/tune`` unless ``--out`` names
another); the compiler's ``-Xptxas -v`` reports go to
``DIR/tune_kde_build.log``.
"""

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((2, 128), (4, 128), (8, 128), (4, 64), (8, 64), (2, 256),
          (4, 256))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build(shapes, log):
    """{(R, T): the bound entry points of that build}, built in
    parallel."""
    from pisa_tpu_torch.ops import kde as ops_kde
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    specs = {f"kde_gauss_r{r}_t{t}": (
        [ops_kde._CSRC], [f"-DKDE_SUM_R={r}", f"-DKDE_SUM_THREADS={t}",
                          f"-DKDE_VJP_R={r}", f"-DKDE_VJP_THREADS={t}"])
        for r, t in shapes}
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        libs = build_libraries(specs)
    log.write(err.getvalue())
    print(f"built {len(specs)} libraries in {time.perf_counter() - t0:.1f} s")
    return {(r, t): ops_kde.bind_library(libs[f"kde_gauss_r{r}_t{t}"])
            for r, t in shapes}


def parent_fns(path):
    """The sum and vjp entry points of an earlier source without live
    counts, built with the same flags."""
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    lib = build_libraries({"kde_gauss_parent": ([path], [])})[
        "kde_gauss_parent"]
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = {}
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"kde_gauss_sum_{suffix}")
        fn.argtypes = [P, P, LL, P, P, P, P, I, I, I, I, P]
        fn.restype = I
        fns[f"sum_{suffix}"] = fn
        fn = getattr(lib, f"kde_gauss_sum_vjp_{suffix}")
        fn.argtypes = [P, P, LL, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
        fns[f"vjp_{suffix}"] = fn
    return fns


def parent_call(fns, kind, args):
    """A closure launching the earlier source's `kind` kernel on `args`
    (x, p, ih, il2, c or g)."""
    import torch

    x, p, ih, il2, last = args
    B, D, N = x.shape
    M = p.shape[-1]
    bstride = 0 if p.dim() == 2 else D * M
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    if kind == "sum":
        out = torch.empty((B, M), dtype=x.dtype, device=x.device)
        outs = (out,)
    else:
        outs = (torch.empty((B, N), dtype=x.dtype, device=x.device),
                torch.empty((B, D, N), dtype=x.dtype, device=x.device))

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns[f"{kind}_{suffix}"](
            x.data_ptr(), p.data_ptr(), bstride, ih.data_ptr(),
            il2.data_ptr(), last.data_ptr(),
            *(o.data_ptr() for o in outs), B, D, N, M, stream)
        if rc != 0:
            raise RuntimeError(f"parent {kind}: CUDA error {rc}")
        return outs
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="an earlier kde_gauss.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune"))
    ap.add_argument("--shapes", help="R:T pairs, comma-separated")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from pisa_tpu_torch.ops import kde as ops_kde

    if not torch.cuda.is_available():
        print("tune_kde.py needs an NVIDIA card", file=sys.stderr)
        return 1
    shapes = SHAPES if not args.shapes else tuple(
        tuple(int(v) for v in s.split(":")) for s in args.shapes.split(","))
    os.makedirs(args.out, exist_ok=True)
    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with open(os.path.join(args.out, "tune_kde_build.log"), "w") as log:
        t0 = time.perf_counter()
        shipped = ops_kde.kernel_library()
        libs = build(shapes, log)
        parent = parent_fns(args.parent_source) if args.parent_source \
            else None
        print(f"builds: {time.perf_counter() - t0:.1f} s")
    rows = []
    cases = {}
    for case in ("dense", "live"):
        inp = cs.kde_inputs(torch.float64, live=case == "live")
        B, D, N = inp["x"].shape
        n_rows = [N] * B if inp["counts"] is None else inp["counts"].tolist()
        for kind, label, shared, a64, n_live, m_live in \
                cs.kde_kernel_cases(inp):
            for dtype in (torch.float32, torch.float64):
                a = tuple(t.to(dtype).contiguous() for t in a64)
                plain = ops_kde.gauss_sum_reference if kind == "sum" \
                    else ops_kde.gauss_sum_vjp_reference
                want = plain(*a, n_live, m_live)
                want = (want,) if kind == "sum" else want
                M = a[1].shape[-1]
                m_rows = None if m_live is None else n_rows
                bound, _ = ops_kde.kde_bound_ms(
                    kind, B, D, N, M, dtype, shared_points=shared,
                    n_live=n_rows, m_live=m_rows)
                cases[(case, kind, label, str(dtype))] = (
                    a, n_live, m_live, want, bound, (B, D, N, M))

    def measure(tag, key, fn, splits, attrs):
        a, n_live, m_live, want, bound, (B, D, N, M) = cases[key]
        got = fn()
        got = (got,) if isinstance(got, torch.Tensor) else got
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max()
                        / w.double().abs().max()) for g, w in zip(got, want))
        ms = cs.graph_time(fn, launches=20, replays=3)
        row = {"build": tag, "case": key[0], "kernel": key[1],
               "pass": key[2], "dtype": key[3], "splits": splits, "ms": ms,
               "bound_ms": bound, "share": bound / ms, "max_rel_err": err,
               "ok": err <= cs.KDE_KERNEL_RTOL[key[3].split(".")[-1]],
               **(attrs or {})}
        rows.append(row)
        print(f"{tag} {key[1]} {key[0]} {key[2]} {key[3]} splits {splits}:"
              f" {ms:.4f} ms, {100 * bound / ms:.1f}% of the live bound,"
              f" error {err:.2e}{'' if row['ok'] else ' OFF'}"
              f"{'' if not attrs else ', %d registers, %d local bytes, %d blocks/SM' % (attrs['registers'], attrs['local_bytes'], attrs['blocks_per_sm'])}"
              f" [{smi}]")

    def parent_round(which):
        for key in sorted(cases):
            case, kind, label, dname = key
            if case != "dense":
                continue
            fn = parent_call(parent, kind, cases[key][0])
            measure(f"parent ({which})", key, fn, 1, None)

    if parent:
        parent_round("first")
    for (r, t), lib in [(("shipped", ""), shipped)] + list(libs.items()):
        tag = "shipped" if r == "shipped" else f"R={r} T={t}"
        for key in sorted(cases):
            case, kind, label, dname = key
            if dname.endswith("float64") and r != "shipped":
                continue
            a, n_live, m_live = cases[key][:3]
            dtype = a[0].dtype
            B, D, N, M = cases[key][5]
            wrapper = ops_kde.gauss_sum if kind == "sum" \
                else ops_kde.gauss_sum_vjp
            attrs = ops_kde.kernel_attributes(kind, D, dtype, lib)
            policy = ops_kde.launch_splits(
                kind, D, dtype, B, M if kind == "sum" else N,
                N if kind == "sum" else M, lib)
            for splits in sorted({1, policy, 2 * policy}):
                measure(tag, key, lambda: wrapper(
                    *a, n_live, m_live, splits=splits, lib=lib), splits,
                    attrs)
    if parent:
        parent_round("last")
    best = {}
    for row in rows:
        if not row["ok"] or row["build"].startswith("parent"):
            continue
        k = (row["kernel"], row["case"], row["pass"], row["dtype"])
        if k not in best or row["ms"] < best[k]["ms"]:
            best[k] = row
    for k, row in sorted(best.items()):
        print(f"best {k}: {row['build']}, splits {row['splits']},"
              f" {row['ms']:.4f} ms ({100 * row['share']:.1f}% of the live"
              f" bound) [{smi}]")
    with open(os.path.join(args.out, "tune_kde.json"), "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    bad = [r for r in rows if not r["ok"]]
    print(f"{len(rows)} measurements, {len(bad)} off their plain version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
