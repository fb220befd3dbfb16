"""CLI for the pre-flight static verifier.

Port of ``repro/analysis/cli.py``, with the same exit codes.

Usage::

    python -m repro_torch.analysis check      # all nets + shipped plans
                                              # + CUDA lints
    python -m repro_torch.analysis check --net resnet50 \\
        --plan-cache plans/resnet50.json --json
    python -m repro_torch.analysis rules      # rule catalogue

``check`` exits 0 when no error-severity diagnostics were found, 1
otherwise (warnings and infos never fail the run; CI gates on errors).
``--json`` prints the machine-readable report instead of the human one.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Pre-flight static verifier for kernel schedules, "
        "plan caches, and lowered programs.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser(
        "check",
        help="verify networks, plan caches, and kernel sources",
    )
    c.add_argument(
        "--net",
        action="append",
        dest="nets",
        metavar="NAME",
        help="network to check (repeatable; default: all of "
        "alexnet/googlenet/resnet50)",
    )
    c.add_argument(
        "--plan-cache",
        action="append",
        dest="plan_caches",
        metavar="PATH",
        help="plan-cache file to audit and resolve against the nets "
        "(repeatable; default: each net's shipped plans/<net>.json)",
    )
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--image", type=int, default=224)
    c.add_argument("--dtype", default="float32")
    c.add_argument(
        "--backend",
        default="cpu",
        help="backend component of the cache keys to resolve (default: cpu, "
        "the shipped plans' key)",
    )
    c.add_argument(
        "--no-lints",
        action="store_true",
        help="skip the CUDA kernel-source lints",
    )
    c.add_argument(
        "--kernel-path",
        action="append",
        dest="kernel_paths",
        metavar="PATH",
        help="CUDA source file to lint (repeatable; default: every .cu "
        "under src/repro_torch/kernels/*/csrc)",
    )
    c.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="machine-readable JSON report on stdout",
    )
    sub.add_parser("rules", help="print the rule catalogue")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    # Heavy imports after argparse so `--help` stays instant.
    from repro_torch.analysis.checker import ALL_RULES, run_check

    if args.cmd == "rules":
        width = max(len(r) for r in ALL_RULES)
        for rule in sorted(ALL_RULES):
            severity, doc = ALL_RULES[rule]
            print(f"{rule:<{width}}  {severity:<7}  {doc}")
        return 0
    report = run_check(
        nets=args.nets,
        plan_caches=args.plan_caches,
        batch=args.batch,
        image=args.image,
        dtype=args.dtype,
        backend=args.backend,
        lint_paths=args.kernel_paths,
        lints=not args.no_lints,
    )
    if args.as_json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.format_human())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
