"""
Unit-test runner (counterpart of ``pisa_tpu/scripts/run_unit_tests.py``;
cf. reference ``pisa-run_unit_tests``, entry of
``pisa_tests/run_unit_tests.py:110``): runs the port's test files
(``tests/test_torch_*.py``, which hold pisa_tpu_torch against the JAX
package on the CPU) under the requested precision(s). The runner locates
the tree (the checkout that holds ``pisa_tpu_torch``, or
``PISA_TPU_TESTS``) and adds the reference's dual-precision CI behavior
(fp64 and fp32 legs through ``PISA_TPU_FTYPE``) plus named sub-suites for
the reference's specialized test entry points (``pisa-test_kde_stage``,
``pisa-test_example_pipelines``, ``pisa-test_services``).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

# reference specialized harnesses -> the port's test files (glob patterns
# relative to the tree)
SUITES = {
    "all": ["tests/test_torch_*.py"],
    "kde": ["tests/test_torch_kde*.py"],
    "examples": ["tests/test_torch_pipeline.py", "tests/test_torch_events.py"],
    "services": ["tests/test_torch_osc_services.py",
                 "tests/test_torch_services_rest.py",
                 "tests/test_torch_flux_xsec.py"],
    "osc-golden": ["tests/test_torch_chain.py",
                   "tests/test_torch_chain_source.py"],
    "cli": ["tests/test_torch_cli.py", "tests/test_torch_llh_server.py",
            "tests/test_torch_tools.py"],
}


def _tests_dir():
    env = os.environ.get("PISA_TPU_TESTS")
    if env:
        return env
    # repo checkout: tests/ next to the package's parent
    import pisa_tpu_torch

    repo = os.path.dirname(
        os.path.dirname(os.path.abspath(pisa_tpu_torch.__file__)))
    cand = os.path.join(repo, "tests")
    if os.path.isdir(cand):
        return repo
    raise SystemExit(
        "cannot locate the test tree; set PISA_TPU_TESTS to the repo root"
    )


def suite_files(suite, repo):
    """The test files of `suite` in the tree at `repo`, sorted, relative to
    it; a pattern that matches nothing raises."""
    files = []
    for pattern in SUITES[suite]:
        found = sorted(os.path.relpath(p, repo)
                       for p in glob.glob(os.path.join(repo, pattern)))
        if not found:
            raise SystemExit(f"no test file matches {pattern} in {repo}")
        files.extend(found)
    return files


def main(argv=None):
    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "--suite", choices=sorted(SUITES), default="all",
        help="named sub-suite (reference specialized harnesses)",
    )
    parser.add_argument(
        "--ftype", choices=["fp64", "fp32", "both"], default="fp64",
        help="precision leg(s); 'both' mirrors the reference CI matrix",
    )
    parser.add_argument("-k", default=None, help="pytest -k expression")
    parser.add_argument("-x", action="store_true", help="stop on first fail")
    args = parser.parse_args(argv)

    repo = _tests_dir()
    files = suite_files(args.suite, repo)
    ftypes = ["fp64", "fp32"] if args.ftype == "both" else [args.ftype]
    rc = 0
    for ftype in ftypes:
        cmd = [sys.executable, "-m", "pytest", "-q", *files]
        if args.k:
            cmd += ["-k", args.k]
        if args.x:
            cmd.append("-x")
        env = dict(os.environ, PISA_TPU_FTYPE=ftype)
        print(f"== pytest leg: PISA_TPU_FTYPE={ftype} ==", flush=True)
        rc |= subprocess.call(cmd, cwd=repo, env=env)
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
