#!/usr/bin/env python3
"""
Tune the register tiles of the KDE kernels of ``pisa_tpu_torch``
(``csrc/kde_gauss.cu``: ``sum_kernel``, ``vjp_kernel`` and ``jvp_kernel``)
on one NVIDIA card, and time them beside an earlier source in the same
process.

Run from the root of a checkout:

    python3 scripts/tune_kde.py [--parent-source FILE.cu] [--out DIR]
                                [--kernels sum,vjp,jvp] [--shapes R:T,...]

Each build sets the outputs per thread (R) and the threads per block (T)
of the kernels (``-DKDE_SUM_R``, ``-DKDE_SUM_THREADS``, ``-DKDE_VJP_R``,
``-DKDE_VJP_THREADS``, ``-DKDE_JVP_R``, ``-DKDE_JVP_THREADS``); the builds
run in parallel, and each nvcc's time is printed. For each build, at
kde_example's shapes (``chip_smoke.kde_inputs``: 24 channels of 20,000
samples, the pilot at the samples and the 1,320-point grid) in the dense
case (every sample live) and the live case (the PID channels' live counts
of ``chip_smoke.kde_live_counts``), in float32, the script checks each
kernel against its float32 plain version (``chip_smoke.KDE_KERNEL_RTOL``),
reads registers, local memory and resident blocks, and times it
device-only (a CUDA graph of 20 launches, 3 replays) at the wrapper's
split count (``ops/kde.py:launch_splits``), at one split and at twice the
wrapper's; the jvp at K = 1 and K = ``chip_smoke.KDE_JVP_K`` directions.
The build as shipped is timed in float64 as well.

With ``--parent-source`` (the source before the jvp's direction axis: its
jvp takes one direction, ``(x, p, p_bstride, ih, dih, il2, dil2, c, dc,
n_live, m_live, out, dout, B, D, N, M, stream)``), that source's jvp is
timed first and last, around the builds, at one direction and at the
Fisher matrix's K directions folded into K x 24 rows (the earlier
design's only route for K directions).

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


def build(shapes, kernels, parent, log):
    """({(R, T): the bound entry points of that build}, the parent
    source's jvp entry points or None), built in parallel with the
    shipped build; the shapes set the tiles of `kernels`."""
    from pisa_tpu_torch.ops import kde as ops_kde
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    macros = {"sum": ("KDE_SUM_R", "KDE_SUM_THREADS"),
              "vjp": ("KDE_VJP_R", "KDE_VJP_THREADS"),
              "jvp": ("KDE_JVP_R", "KDE_JVP_THREADS")}
    specs = {"kde_gauss": ([ops_kde._CSRC], [])}
    for r, t in shapes:
        specs[f"kde_gauss_r{r}_t{t}"] = ([ops_kde._CSRC], [
            f"-D{m}={v}" for k in kernels for m, v in zip(macros[k], (r, t))])
    if parent:
        specs["kde_gauss_parent"] = ([parent], [])
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        libs = build_libraries(specs)
    log.write(err.getvalue())
    for line in err.getvalue().splitlines():
        if line.startswith("[cuda_build] built"):
            print(line)
    print(f"built {len(specs)} libraries in {time.perf_counter() - t0:.1f} s")
    ops_kde._LIB = ops_kde.bind_library(libs["kde_gauss"])
    return ({(r, t): ops_kde.bind_library(libs[f"kde_gauss_r{r}_t{t}"])
             for r, t in shapes},
            parent_jvp(libs["kde_gauss_parent"]) if parent else None)


def parent_jvp(lib):
    """The one-direction jvp entry points of an earlier source."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = {}
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"kde_gauss_sum_jvp_{suffix}")
        fn.argtypes = [P, P, LL] + [P] * 10 + [I] * 4 + [P]
        fn.restype = I
        fns[suffix] = fn
    return fns


def parent_call(fns, args, n_live, m_live):
    """A closure launching the earlier source's jvp on `args` (x, p, ih,
    dih, il2, dil2, c, dc; one direction)."""
    import torch

    x, p, ih, dih, il2, dil2, c, dc = args
    B, D, N = x.shape
    M = p.shape[-1]
    bstride = 0 if p.dim() == 2 else D * M
    suffix = "f64" if x.dtype == torch.float64 else "f32"
    out = torch.empty((B, M), dtype=x.dtype, device=x.device)
    dout = torch.empty((B, M), dtype=x.dtype, device=x.device)
    n_ptr = None if n_live is None else n_live.data_ptr()
    m_ptr = None if m_live is None else m_live.data_ptr()

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        rc = fns[suffix](*(t.data_ptr() for t in (x, p)), bstride,
                         *(t.data_ptr() for t in (ih, dih, il2, dil2, c,
                                                  dc)),
                         n_ptr, m_ptr, out.data_ptr(), dout.data_ptr(), B, D,
                         N, M, stream)
        if rc != 0:
            raise RuntimeError(f"parent jvp: CUDA error {rc}")
        return out, dout
    return call


def folded(args, n_live, m_live):
    """The K-direction jvp arguments folded as the earlier design's vmap
    rule folded them: the K directions as K more rows of the batch."""
    import torch

    x, p, ih, dih, il2, dil2, c, dc = args
    K = dih.shape[0]

    def rows(t):
        return t.unsqueeze(0).expand((K,) + tuple(t.shape)).reshape(
            (-1,) + tuple(t.shape[1:])).contiguous()
    pf = p if p.dim() == 2 else rows(p)
    counts = [None if t is None else rows(t) for t in (n_live, m_live)]
    return (rows(x), pf, rows(ih), dih.reshape(-1, dih.shape[-1]),
            rows(il2), dil2.reshape(-1, dil2.shape[-1]), rows(c),
            dc.reshape(-1, dc.shape[-1])), counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="an earlier kde_gauss.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune"))
    ap.add_argument("--kernels", default="sum,vjp,jvp",
                    help="the kernels to tune, comma-separated")
    ap.add_argument("--shapes", help="R:T pairs, comma-separated")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pisa_tpu_torch.ops import kde as ops_kde

    if not torch.cuda.is_available():
        print("tune_kde.py needs an NVIDIA card", file=sys.stderr)
        return 1
    kernels = args.kernels.split(",")
    shapes = SHAPES if not args.shapes else tuple(
        tuple(int(v) for v in s.split(":")) for s in args.shapes.split(","))
    os.makedirs(args.out, exist_ok=True)
    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with open(os.path.join(args.out, "tune_kde_build.log"), "w") as log:
        t0 = time.perf_counter()
        libs, parent = build(shapes, kernels, args.parent_source, log)
        shipped = ops_kde.kernel_library()
        print(f"builds: {time.perf_counter() - t0:.1f} s")
    K = cs.KDE_JVP_K
    rng = np.random.RandomState(2)
    rows = []
    cases = {}
    for case in ("dense", "live"):
        inp = cs.kde_inputs(torch.float64, live=case == "live")
        B, D, N = inp["x"].shape
        n_rows = [N] * B if inp["counts"] is None else inp["counts"].tolist()
        calls = list(cs.kde_kernel_cases(inp))
        # the jvp's passes: K seeded directions (chip_smoke.kde_jvp_vs_plain)

        def direction(t):
            return t * torch.as_tensor(rng.uniform(
                -cs.KDE_JVP_DIRECTION, cs.KDE_JVP_DIRECTION,
                (K,) + tuple(t.shape)), device="cuda")
        x, n = inp["x"], inp["counts"]
        zeros = torch.zeros((K,) + tuple(inp["ones"].shape),
                            dtype=torch.float64, device="cuda")
        dih = direction(inp["ih"])
        calls += [
            ("jvp", "pilot", False, (x, x, inp["ih"], dih, inp["ones"],
                                     zeros, inp["c0"], direction(inp["c0"])),
             n, n),
            ("jvp", "grid", True, (x, inp["points"], inp["ih"], dih,
                                   inp["il2"], direction(inp["il2"]),
                                   inp["c"], direction(inp["c"])), n, None)]
        for kind, label, shared, a64, n_live, m_live in calls:
            if kind not in kernels:
                continue
            for dtype in (torch.float32, torch.float64):
                a = tuple(t.to(dtype).contiguous() for t in a64)
                plain = {"sum": ops_kde.gauss_sum_reference,
                         "vjp": ops_kde.gauss_sum_vjp_reference,
                         "jvp": ops_kde.gauss_sum_jvp_reference}[kind]
                want = plain(*a, n_live, m_live)
                want = (want,) if kind == "sum" else want
                M = a[1].shape[-1]
                m_rows = None if m_live is None else n_rows
                for k in ((1, K) if kind == "jvp" else (1,)):
                    ak, wk = a, want
                    if kind == "jvp" and k == 1:
                        ak = a[:3] + (a[3][:1],) + a[4:5] + (a[5][:1],) \
                            + a[6:7] + (a[7][:1],)
                        wk = (want[0], want[1][:1])
                    bound, _ = ops_kde.kde_bound_ms(
                        kind, B, D, N, M, dtype, shared_points=shared,
                        n_live=n_rows, m_live=m_rows, directions=k)
                    cases[(case, kind, label, k, str(dtype))] = (
                        ak, n_live, m_live, wk, bound, (B, D, N, M))

    def measure(tag, key, fn, splits, attrs, want=None):
        a, n_live, m_live, want_k, bound, (B, D, N, M) = cases[key]
        want = want_k if want is None else want
        got = fn()
        got = (got,) if isinstance(got, torch.Tensor) else got
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max()
                        / w.double().abs().max()) for g, w in zip(got, want))
        ms = cs.graph_time(fn, launches=20, replays=3)
        row = {"build": tag, "case": key[0], "kernel": key[1],
               "pass": key[2], "directions": key[3], "dtype": key[4],
               "splits": splits, "ms": ms, "bound_ms": bound,
               "share": bound / ms, "max_rel_err": err,
               "ok": err <= cs.KDE_KERNEL_RTOL[key[4].split(".")[-1]],
               **(attrs or {})}
        rows.append(row)
        print(f"{tag} {key[1]} {key[0]} {key[2]} K={key[3]} {key[4]} splits"
              f" {splits}: {ms:.4f} ms, {100 * bound / ms:.1f}% of the live"
              f" bound, error {err:.2e}{'' if row['ok'] else ' OFF'}"
              f"{'' if not attrs else ', %d registers, %d local bytes, %d blocks/SM' % (attrs['registers'], attrs['local_bytes'], attrs['blocks_per_sm'])}"
              f" [{smi}]")

    def parent_round(which):
        """The earlier jvp at one direction, and at K directions folded
        into K x B rows, in float32."""
        for key in sorted(cases):
            case, kind, label, k, dname = key
            if kind != "jvp" or not dname.endswith("float32"):
                continue
            a, n_live, m_live, want = cases[key][:4]
            if k == 1:
                one = a[:3] + (a[3][0],) + a[4:5] + (a[5][0],) + a[6:7] \
                    + (a[7][0],)
                counts = [None if t is None else t.to(torch.int32)
                          for t in (n_live, m_live)]
                fn = parent_call(parent, one, *counts)
                measure(f"parent ({which})", key, fn, 1, None,
                        (want[0], want[1][0]))
            else:
                fa, counts = folded(a, n_live, m_live)
                counts = [None if t is None else t.to(torch.int32)
                          for t in counts]
                fn = parent_call(parent, fa, *counts)
                B = a[0].shape[0]
                measure(f"parent ({which}, {k} x {B} rows)", key,
                        lambda: (lambda o: (o[0][:B], o[1].reshape(
                            k, B, -1)))(fn()), 1, None)

    if parent:
        parent_round("first")
    for (r, t), lib in [(("shipped", ""), shipped)] + list(libs.items()):
        tag = "shipped" if r == "shipped" else f"R={r} T={t}"
        for key in sorted(cases):
            case, kind, label, k, dname = key
            if dname.endswith("float64") and r != "shipped":
                continue
            a, n_live, m_live = cases[key][:3]
            dtype = a[0].dtype
            B, D, N, M = cases[key][5]
            wrapper = {"sum": ops_kde.gauss_sum, "vjp": ops_kde.gauss_sum_vjp,
                       "jvp": ops_kde.gauss_sum_jvp}[kind]
            attrs = ops_kde.kernel_attributes(kind, D, dtype, lib, k)
            outer, inner = (N, M) if kind == "vjp" else (M, N)
            policy = ops_kde.launch_splits(kind, D, dtype, B, outer, inner,
                                           lib, k)
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
        k = (row["kernel"], row["case"], row["pass"], row["directions"],
             row["dtype"])
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
