"""
Build the port's CUDA sources into shared libraries with a plain C
interface, loaded through ``ctypes``.

Each library is compiled at first use, from the ``.cu`` sources in the
checkout only, into ``build/pisa_tpu_torch/`` beside the package. The file
name carries a hash of the sources and flags, so an edited source forces a
rebuild. Libraries asked for together are compiled in parallel, one ``nvcc``
each. The compiler's ``-Xptxas -v`` report (registers, spills, shared memory
per kernel) is printed once, when a library is built, with the seconds that
its ``nvcc`` took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

__all__ = ["build_libraries", "BUILD_DIR", "NVCC_FLAGS"]

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "pisa_tpu_torch",
)

# No fast-math: the oscillation kernel's phases reach tens of radians, where
# the fast sin/cos intrinsics lose their range reduction.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA"
        " kernels of pisa_tpu_torch need the CUDA toolkit"
    )


def _library_path(name, sources, flags):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_libraries(specs):
    """Compile and load shared libraries.

    `specs` maps a library name to ``(sources, flags)``: the paths of its
    .cu files and extra nvcc flags (e.g. ``-D`` defines). Each library is
    built into ``lib<name>-<hash>.so`` under :data:`BUILD_DIR` unless it
    already exists; the missing ones are compiled concurrently. Returns
    ``{name: ctypes.CDLL}``."""
    paths = {
        name: _library_path(name, sources, flags)
        for name, (sources, flags) in specs.items()
    }
    jobs = {}
    for name, (sources, flags) in specs.items():
        if os.path.exists(paths[name]):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, *sources]
        out = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                text=True)
        jobs[name] = (cmd, tmp, proc, out, time.perf_counter())
    # each build's own time, from its start to its exit
    took = {}
    while len(took) < len(jobs):
        for name, (_, _, proc, _, t0) in jobs.items():
            if name not in took and proc.poll() is not None:
                took[name] = time.perf_counter() - t0
        time.sleep(0.05)
    failures = []
    for name, (cmd, tmp, proc, out, _) in jobs.items():
        out.seek(0)
        log = out.read()
        out.close()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
            continue
        print(f"[cuda_build] built {paths[name]} in {took[name]:.1f} s",
              file=sys.stderr)
        print(log, file=sys.stderr, end="")
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: ctypes.CDLL(path) for name, path in paths.items()}
