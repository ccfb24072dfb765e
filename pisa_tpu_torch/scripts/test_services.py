"""
Service support-matrix CLI (counterpart of
``pisa_tpu/scripts/test_services.py``; cf. reference ``pisa-test_services``,
entry of ``pisa_tests/test_services.py:201``): discover every service, run
each in the events and (where supported) binned calc modes against
synthetic containers on ``--device`` (the card by default), and
print/write the markdown support matrix. Exits 1 if a service fails.
"""

from __future__ import annotations


def main(argv=None):
    from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

    parser = ArgumentParser(
        description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "--outfile", default=None,
        help="also write the markdown matrix to this path",
    )
    parser.add_argument("-v", action="store_true", help="per-service output")
    parser.add_argument("--device", default="cuda",
                        help="device of the services' containers")
    args = parser.parse_args(argv)

    from pisa_tpu_torch.testing.service_matrix import (
        format_markdown_matrix,
        generate_matrix,
    )

    rows = generate_matrix(verbose=args.v, device=args.device)
    md = format_markdown_matrix(rows)
    print(md)
    n_ok = sum(r[2] == "ok" for r in rows)
    n_fail = sum(r[2].startswith("FAIL") or r[3].startswith("FAIL") for r in rows)
    print(
        f"\n{len(rows)} services: {n_ok} ok (events mode), {n_fail} failing"
    )
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(md + "\n")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
