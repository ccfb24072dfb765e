#!/usr/bin/env python3
"""
Time ``herm4_eig`` (``csrc/herm4_eig.cu``: one thread a matrix, its block's
matrices staged through shared memory as 16-byte words) on one NVIDIA card,
beside an earlier source, in one process.

Run from the root of a checkout:

    python3 scripts/tune_herm4.py [--parent-source FILE.cu] [--out DIR]

At the 3+1 flagship's 279,600 layer steps of one sign (the nominal point,
``chip_smoke.sterile_steps``), in float32 and float64, each build is checked
against the plain version (``torch.linalg.eigh`` in chunks,
``chip_smoke.HERM4_TOL`` of each matrix's norm) and timed device-only (a
CUDA graph of 20 launches, 5 replays) in the order parent, kernel, kernel,
parent, with the kernel's registers, resident blocks and
the bound (``chip_smoke.herm4_vs_plain``'s: the bytes, or the operations of
``ops/osc/herm4.py:herm4_operations`` over the sweeps the matrices took).
The earlier source (``--parent-source``) has the same entry points; its
functions are bound here and launched on the same inputs.

It prints one line per measurement with the card's name and power limit,
and writes them to ``DIR/tune_herm4.json`` (DIR: ``build/tune`` unless
``--out`` names another).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parent_eig(lib, H):
    """The eigenvalues and eigenvectors of `H` (n, 4, 4) on the card from an
    earlier build's bound entry points, launched on the current stream."""
    import torch

    from pisa_tpu_torch.ops.osc import herm4

    n = H.shape[0]
    real = torch.float64 if H.dtype == torch.complex128 else torch.float32
    w = torch.empty((n, 4), dtype=real, device=H.device)
    v = torch.empty((n, 4, 4), dtype=H.dtype, device=H.device)
    fn = lib.herm4_eig_f64 if real == torch.float64 else lib.herm4_eig_f32
    stream = torch.cuda.current_stream(H.device).cuda_stream
    rc = fn(H.data_ptr(), w.data_ptr(), v.data_ptr(), None, n, stream)
    if rc != 0:
        raise RuntimeError(f"parent herm4_eig: CUDA error {rc}")
    return w, v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="an earlier herm4_eig.cu")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tune"))
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from pisa_tpu_torch.ops.osc import herm4, sterile
    from pisa_tpu_torch.utils.cuda_build import build_libraries

    if not torch.cuda.is_available():
        print("tune_herm4.py needs an NVIDIA card", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = card_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    run = {"kernel": lambda H, sweeps=False: herm4.herm4_eig(H, sweeps)}
    if args.parent_source:
        parent = build_libraries(
            {"herm4_eig_parent": ([args.parent_source], [])})[
                "herm4_eig_parent"]
        for suffix in ("f32", "f64"):
            fn = getattr(parent, f"herm4_eig_{suffix}")
            fn.argtypes = [herm4._P] * 4 + [herm4._LL, herm4._P]
        run["parent"] = lambda H: parent_eig(parent, H)
    order = (["parent"] if args.parent_source else []) + ["kernel"]
    order = order + order[::-1]

    geom, params = cs.sterile_steps(torch.float64)
    angles, dms = cs.sterile_points(params)[0]
    U = sterile.pmns4_matrix(*angles, device="cuda")
    H64 = sterile.layer_hamiltonians(
        U, torch.tensor(dms, dtype=torch.float64, device="cuda"), 1,
        geom["e"], geom["rho_e"], geom["rho_n"])
    n = H64.shape[0]
    rows = []
    for dname, cdt in (("float32", torch.complex64),
                       ("float64", torch.complex128)):
        H = H64.to(cdt).contiguous()
        want = cs.herm4_plain(herm4, H)[0].double()
        norm = torch.linalg.matrix_norm(H.to(torch.complex128))
        size = 4 if dname == "float32" else 8
        nbytes = n * (32 + 4 + 32) * size
        for name in order:
            fn = run[name]
            w = fn(H)[0]
            err = float(((w.double() - want).abs() / norm[:, None]).max())
            ms = cs.graph_time(lambda: fn(H), launches=20, replays=5)
            row = {"build": name, "dtype": dname, "matrices": n, "ms": ms,
                   "max_rel_err": err, "ok": err <= cs.HERM4_TOL[dname]}
            if name != "parent":
                _, _, sweeps = fn(H, sweeps=True)
                ops = herm4.herm4_operations(sweeps.cpu())
                t_ops = ops / cs.PEAK_FLOPS[dname] * 1e3
                t_bytes = nbytes / cs.HBM_BYTES_PER_S * 1e3
                row.update(herm4.kernel_attributes(cdt),
                           sweeps_mean=float(sweeps.float().mean()),
                           operations=ops, bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes")
                row["share"] = row["bound_ms"] / ms
            rows.append(row)
            extra = "" if name == "parent" else (
                f", bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
                f" ({100 * row['share']:.1f}%), {row['sweeps_mean']:.2f}"
                f" sweeps a matrix, {row['registers']} registers,"
                f" {row['local_bytes']} local bytes, {row['blocks_per_sm']}"
                f" blocks of {row['threads']} per SM")
            print(f"herm4_eig {name} {dname}, {n} matrices: {ms:.4f} ms,"
                  f" {err:.3e} of |H| off the plain version (bound"
                  f" {cs.HERM4_TOL[dname]:g}){extra} [{smi}]")
    with open(os.path.join(args.out, "tune_herm4.json"), "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    bad = [r for r in rows if not r["ok"]]
    print(f"{len(rows)} measurements, {len(bad)} off the plain version")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
