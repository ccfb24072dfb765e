#!/usr/bin/env python3
"""
Tune the shape of the CUDA multitangent chain kernel of ``pisa_tpu_torch``
(``csrc/osc_chain.cu:tile_multi_kernel``) on one NVIDIA card.

Run from the root of a checkout:

    python3 scripts/tune_chain_multitangent.py [--parent-source FILE.cu]
                                               [--out DIR]

The kernel's shape is, per float type and number of directions K: the
directions per thread of its phase 1 (c1) and phase 2 (c2), the block's
threads, and the steps a tile holds. The first three are compile-time
(``MultiShape``, overridden for a whole build by ``-DOSC_MT_C1``,
``-DOSC_MT_C2``, ``-DOSC_MT_THREADS``); the tile's steps are the tile
table's. The script builds one library per (c1, c2, threads) in parallel,
and for each, at the flagship's geometry (``chip_smoke.flagship_geometry``),
for K = 1, 3 and 6 in float32 and float64 and for tables cut to 128, 64 and
32 steps: checks the kernel against the primal kernel and K launches of the
tangent kernel, reads its registers, local memory, shared memory and
resident blocks, and times it device-only (a CUDA graph of 200 launches).
Beside them, in the same run: the build as shipped, K launches of the tile
tangent kernel, and, with ``--parent-source``, the multitangent entry points
of an earlier source that ran one thread per point (signature
``(pvec, dpvecs, k, nl, e, dens, dist, out, dout, n, stream)``).

It prints one line per measurement and the best shape per (float type, K),
and writes everything to ``DIR/tune_chain_multitangent.json`` (DIR:
``build/tune`` unless ``--out`` names another); the compiler's ``-Xptxas
-v`` reports go to ``DIR/tune_chain_multitangent_build.log``.
"""

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (c1, c2, threads) of the builds
SHAPES = (
    [(c1, c2, 128) for c1 in (1, 2, 3, 6) for c2 in (1, 2, 3, 6)]
    + [(c1, c2, 256) for c1, c2 in ((1, 1), (2, 1), (3, 1), (2, 2), (3, 3),
                                    (6, 6))]
    + [(1, 1, 384), (2, 1, 384)]
)
TILE_STEPS = (128, 64, 32)
KS = (1, 3, 6)
PARALLEL_BUILDS = 8
# kernel vs the primal and tangent kernels: the same arithmetic per
# direction, so they agree to rounding of fused multiply-adds
AGREE = {"float64": 1e-12, "float32": 1e-4}


def build(specs, log):
    """build_libraries in batches, the compiler's report appended to
    `log`; returns {name: CDLL} and the spill stores the report gives per
    (name, 'f' or 'd', K)."""
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    libs, spills = {}, {}
    names = list(specs)
    for i in range(0, len(names), PARALLEL_BUILDS):
        batch = {n: specs[n] for n in names[i:i + PARALLEL_BUILDS]}
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            libs.update(build_libraries(batch))
        print(f"built {len(batch)} libraries in"
              f" {time.perf_counter() - t0:.1f} s", flush=True)
        log.write(err.getvalue())
        spills.update(parse_spills(err.getvalue()))
    return libs, spills


def parse_spills(report):
    """{(library name, 'f'/'d', K): spill-store bytes} from cuda_build's
    output: '[cuda_build] built .../lib<name>-<hash>.so', then per kernel a
    'Compiling entry function' line with the mangled name and a 'spill
    stores' line."""
    out, name, key = {}, None, None
    for line in report.splitlines():
        m = re.search(r"\[cuda_build\] built .*/lib(.+)-[0-9a-f]{16}\.so", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"tile_multi_kernelI([fd])Li(\d)E", m.group(1))
            key = (name, k.group(1), int(k.group(2))) if k else None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key:
            out[key] = int(m.group(1))
    return out


def bind(lib, suffix, parent=False):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"osc_chain_multitangent_{suffix}")
    attrs = getattr(lib, f"osc_chain_multitangent_attributes_{suffix}")
    if parent:
        fn.argtypes = [p, p, i] + [p] * 6 + [i, p]
        attrs.argtypes = [i, p]
    else:
        # ..., n_tiles, n, tile_steps, lanes, stream
        fn.argtypes = [p, p, i] + [p] * 8 + [i, i, i, i, p]
        attrs.argtypes = [i, i, p]
    fn.restype = attrs.restype = i
    return fn, attrs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="an earlier osc_chain.cu whose"
                    " per-point multitangent is timed beside the new one")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune"),
                    help="directory for the results and the build log")
    args = ap.parse_args()
    out_dir = os.path.abspath(args.out)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    os.environ.setdefault("PISA_TPU_FTYPE", "fp32")
    import torch

    if not torch.cuda.is_available():
        print("needs one NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    from pisa_tpu_torch.ops.osc import chain

    smi = chip_smoke.device_lines()
    os.makedirs(out_dir, exist_ok=True)
    specs = {
        f"mt_{c1}_{c2}_{th}": ([chain._CSRC], [
            "-DOSC_CHAIN_MULTITANGENT", f"-DOSC_MT_C1={c1}",
            f"-DOSC_MT_C2={c2}", f"-DOSC_MT_THREADS={th}"])
        for c1, c2, th in SHAPES
    }
    if args.parent_source:
        specs["parent"] = ([os.path.abspath(args.parent_source)],
                           ["-DOSC_CHAIN_MULTITANGENT"])
    with open(os.path.join(out_dir, "tune_chain_multitangent_build.log"),
              "w") as log:
        libs, spills = build(specs, log)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            chain.kernel_library()
        log.write(err.getvalue())
        shipped_spills = parse_spills(err.getvalue())

    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        suffix = "f64" if dtype == torch.float64 else "f32"
        letter = suffix[0] if dtype == torch.float32 else "d"
        geom, params = chip_smoke.flagship_geometry(dtype)
        geo = (geom["e"], geom["dens"], geom["dist"], geom["nl"])
        n = geom["e"].shape[0]
        dens, dist = (geom[k].T.cpu().numpy() for k in ("dens", "dist"))
        tables = {
            steps: chain.tile_table(dens, dist, dtype=dtype, device="cuda",
                                    steps=steps)
            for steps in TILE_STEPS
        }
        pvec, dirs = chip_smoke.pack_and_directions(
            chain, chip_smoke.flagship_thetas(params)[0], 1, dtype)

        def stream():  # the stream torch launches on now (a graph's, in one)
            return torch.cuda.current_stream().cuda_stream

        for k in KS:
            dpvecs = (dirs[list(chip_smoke.FREE_THETA)] if k == 3
                      else dirs[:k]).contiguous()
            want_p = chain.chain_probs(pvec, *geo, geom["tiles"])
            tangents = lambda: [  # noqa: E731
                chain.chain_tangent(pvec, d, *geo, geom["tiles"])
                for d in dpvecs]
            want_t = torch.stack(tangents())
            scale = want_t.abs().amax(dim=(1, 2, 3), keepdim=True)
            out = torch.empty((2, 3, n), dtype=dtype, device="cuda")
            dout = torch.empty((k, 2, 3, n), dtype=dtype, device="cuda")

            def record(label, launch, info, extra):
                out.fill_(float("nan"))
                dout.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                err_p = float((out - want_p).abs().max())
                err_t = float(((dout - want_t).abs() / scale).max())
                ok = (err_p <= AGREE[dname] and err_t <= 10 * AGREE[dname])
                ms = chip_smoke.graph_time(launch)
                row = {"label": label, "dtype": dname, "k": k, "ms": ms,
                       "ok": ok, "err_primal": err_p, "err_tangent": err_t,
                       "registers": info[0], "local_bytes": info[1],
                       "shared_bytes": info[2], "threads": info[3],
                       "blocks_per_sm": info[4], **extra}
                rows.append(row)
                print(json.dumps(row), flush=True)
                if not ok:
                    raise RuntimeError(f"{label} {dname} K={k} disagrees")

            ms = chip_smoke.graph_time(tangents)
            rows.append({"label": "tile tangents", "dtype": dname, "k": k,
                         "ms": ms})
            print(json.dumps(rows[-1]), flush=True)

            if "parent" in libs:
                fn, attrs = bind(libs["parent"], suffix, parent=True)
                info = (ctypes.c_int * 5)()
                rc = attrs(k, ctypes.addressof(info))
                assert rc == 0, rc

                def launch_parent():
                    rc = fn(pvec.data_ptr(), dpvecs.data_ptr(), k,
                            geom["nl"].data_ptr(), geom["e"].data_ptr(),
                            geom["dens"].data_ptr(), geom["dist"].data_ptr(),
                            out.data_ptr(), dout.data_ptr(), n, stream())
                    assert rc == 0, rc

                record("per-point (parent)", launch_parent, list(info), {})

            def tile_launch(fn, table, steps):
                t = [table[key] for key in chain._TILE_KEYS]

                def launch():
                    rc = fn(pvec.data_ptr(), dpvecs.data_ptr(), k,
                            *(x.data_ptr() for x in t), geom["e"].data_ptr(),
                            out.data_ptr(), dout.data_ptr(), t[0].shape[0],
                            n, steps, 1, stream())
                    assert rc == 0, rc
                return launch

            for name, lib in libs.items():
                if name == "parent":
                    continue
                fn, attrs = bind(lib, suffix)
                for steps, table in tables.items():
                    info = (ctypes.c_int * 7)()
                    rc = attrs(k, steps, ctypes.addressof(info))
                    if rc == 1:  # invalid value: too much shared memory
                        continue
                    assert rc == 0, rc
                    record(name, tile_launch(fn, table, steps), list(info), {
                        "c1": info[5], "c2": info[6], "tile_steps": steps,
                        "spill_stores": spills.get((name, letter, k))})
            steps = chain.TILE_STEPS
            a = chain.kernel_attributes("osc_chain_multitangent", dtype, k)
            lib = chain.kernel_library()
            record("shipped", tile_launch(
                getattr(lib, f"osc_chain_multitangent_{suffix}"),
                geom["tiles"], steps),
                [a[x] for x in ("registers", "local_bytes", "shared_bytes",
                                "threads", "blocks_per_sm")],
                {"c1": a["c1"], "c2": a["c2"], "tile_steps": steps,
                 "spill_stores": shipped_spills.get(
                     ("osc_chain_multitangent", letter, k))})

    print(f"best shapes [{smi}]:")
    for dname in ("float32", "float64"):
        for k in KS:
            mine = [r for r in rows if r["dtype"] == dname and r["k"] == k
                    and "tile_steps" in r and r["label"] != "shipped"]
            for r in sorted(mine, key=lambda r: r["ms"])[:6]:
                print(f"  {dname} K={k}: {r['ms']:.5f} ms  c1={r['c1']}"
                      f" c2={r['c2']} threads={r['threads']}"
                      f" steps={r['tile_steps']} regs={r['registers']}"
                      f" local={r['local_bytes']} B spill stores="
                      f"{r['spill_stores']} blocks/SM={r['blocks_per_sm']}")
            for r in rows:
                if (r["dtype"], r["k"]) == (dname, k) and (
                        "tile_steps" not in r or r["label"] == "shipped"):
                    print(f"  {dname} K={k}: {r['ms']:.5f} ms  {r['label']}"
                          + (f" c1={r['c1']} c2={r['c2']}"
                             f" steps={r['tile_steps']}"
                             if r["label"] == "shipped" else ""))
    with open(os.path.join(out_dir, "tune_chain_multitangent.json"),
              "w") as f:
        json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
