"""CLI: ``python -m repro_torch.lint src/repro_torch chip_smoke.py --strict``.

Exit codes: 0 clean; 1 findings or parse errors; 2 strict-mode meta
failures (a suppression comment naming an unknown rule id).  ``--diff`` is
always informational — per-rule count drift against a baseline JSON is a
review signal, never a gate (``bench_diff.py`` convention).
"""
from __future__ import annotations

import argparse
import json
import sys

from .analyzer import lint_paths
from .findings import (
    diff_summaries,
    format_github,
    format_json,
    format_text,
)
from .rules import RULES


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="PyTorch/CUDA-aware static analysis for the repro_torch port "
                    "(rules RPT001-RPT007; see docs/static_analysis_torch.md)",
    )
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text", help="stdout format")
    parser.add_argument("--strict", action="store_true",
                        help="also fail on suppressions naming unknown rules")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--json-out", default=None, metavar="PATH",
                        help="write the JSON summary document to PATH")
    parser.add_argument("--diff", default=None, metavar="BASELINE",
                        help="print informational per-rule drift vs a "
                             "baseline JSON summary (never affects the "
                             "exit code)")
    args = parser.parse_args(argv)

    rules = None
    if args.select:
        ids = [s.strip() for s in args.select.split(",") if s.strip()]
        missing = [s for s in ids if s not in RULES]
        if missing:
            parser.error(f"unknown rule id(s): {', '.join(missing)} "
                         f"(known: {', '.join(sorted(RULES))})")
        rules = [RULES[s] for s in ids]

    result = lint_paths(args.paths, rules=rules)
    summary = result.summary(paths=args.paths)

    visible = result.findings + result.parse_errors
    if args.format == "json":
        print(format_json(summary))
    elif args.format == "github":
        out = format_github(visible)
        if out:
            print(out)
    else:
        out = format_text(visible)
        if out:
            print(out)
        print(
            f"repro_torch.lint: {result.files} files, "
            f"{summary['findings_total']} finding(s), "
            f"{summary['suppressed_total']} suppressed",
            file=sys.stderr,
        )

    if args.strict and result.unknown_suppressions:
        for f in result.unknown_suppressions:
            print(f"{f.path}:{f.line}: {f.message}", file=sys.stderr)

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(format_json(summary) + "\n")

    if args.diff:
        try:
            with open(args.diff, encoding="utf-8") as fh:
                baseline = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"lint diff: unreadable baseline {args.diff!r}: {e}",
                  file=sys.stderr)
        else:
            print(diff_summaries(baseline, summary), file=sys.stderr)

    if not result.ok:
        return 1
    if args.strict and not result.strict_ok():
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
