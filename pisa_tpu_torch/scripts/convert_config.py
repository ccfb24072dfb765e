"""
Reference-PISA pipeline-config normalizer (counterpart of
``pisa_tpu/scripts/convert_config.py``; cf. reference
``pisa/scripts/convert_config_format.py``): rewrites a config written for
icecube/pisa so it runs under pisa_tpu_torch, and reports compatibility.

The dialects are intentionally identical (ini + ``#include`` +
interpolation + ``param.*`` keys), so conversion is a light rewrite:

- legacy ``pi_<service>`` service names -> ``<service>`` (the renames the
  reference applies at ``pisa/core/pipeline.py:273-276``);
- ``pisa_examples/resources/...`` include/resource paths -> bare resource
  names resolved by the resource finder;
- a report of services referenced by the config that run in
  pisa_tpu_torch only with an external package (:data:`GATED`).
"""

from __future__ import annotations

import re
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

# 'stage.pi_service' -> 'stage.service' wherever it appears (section
# headers and the [pipeline] order line alike)
PI_RENAMES = re.compile(r"(?<=\.)pi_(?=\w)")
RESOURCE_PREFIX = re.compile(r"pisa_examples/resources/")
#: the services that run only with an external package, as
#: ``stage.service``: their init imports it (LeptonWeighter, photospline),
#: as the JAX package's does
GATED = ("data.licloader_weighter", "flux.airs")


def convert_text(text):
    notes = []
    out, n = PI_RENAMES.subn("", text)
    if n:
        notes.append(f"renamed {n} legacy pi_* service section(s)")
    out, n = RESOURCE_PREFIX.subn("", out)
    if n:
        notes.append(
            f"stripped {n} pisa_examples/resources/ path prefix(es) "
            "(resolved by the pisa-tpu resource finder)"
        )
    for name in GATED:
        if re.search(rf"\b{re.escape(name)}\b", out):
            notes.append(
                f"NOTE: service '{name}' requires an external package and"
                " is import-gated in pisa_tpu_torch"
            )
    return out, notes


def main(argv=None):
    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("infile", help="reference-PISA pipeline config")
    parser.add_argument(
        "outfile", nargs="?", default=None,
        help="output path (default: stdout)",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="also parse the converted config with pisa_tpu_torch",
    )
    args = parser.parse_args(argv)

    with open(args.infile) as f:
        text = f.read()
    out, notes = convert_text(text)
    for note in notes:
        print(f"# {note}", file=sys.stderr)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    if args.check:
        if not args.outfile:
            raise SystemExit("--check requires an output file")
        from pisa_tpu_torch.config.parser import parse_pipeline_config

        parse_pipeline_config(args.outfile)
        print("# parse check: OK", file=sys.stderr)


if __name__ == "__main__":
    main()
