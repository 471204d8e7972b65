"""tracelint CLI over the port.

    python -m repro_torch.analysis.lint [paths...] [--json]
                                        [--baseline FILE]
                                        [--write-baseline FILE]
                                        [--select IDS] [--list-rules]

The paths default to ``src/repro_torch`` and ``chip_smoke.py`` (run it
from the root of a checkout).  Exit codes: 0 clean, 1 findings, 2 usage
/ IO error.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.analysis.lint.baseline import (apply_baseline, load_baseline,
                                                write_baseline)
from repro_torch.analysis.lint.core import LintError, lint_paths
from repro_torch.analysis.lint.report import render_json, render_text
from repro_torch.analysis.lint.rules import ALL_RULES, rules_by_id

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="verifier-style invariant linter for the PyTorch/CUDA "
                    "port")
    p.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                   help="files or directories to lint (default: "
                        + " ".join(DEFAULT_PATHS) + ")")
    p.add_argument("--json", action="store_true",
                   help="emit the JSON report instead of text")
    p.add_argument("--baseline", metavar="FILE",
                   help="suppress findings fingerprinted in FILE; "
                        "only new findings fail")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings to FILE as the new "
                        "baseline and exit 0")
    p.add_argument("--select", metavar="IDS",
                   help="comma-separated rule ids to run (e.g. TL001,TL003)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def rule_table() -> list:
    """One line a rule: id, name, description."""
    return [f"{r.id}  {r.name:<20} {r.description}" for r in ALL_RULES]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        print("\n".join(rule_table()))
        return 0

    rules = None
    if args.select:
        by_id = rules_by_id()
        wanted = [s.strip().upper() for s in args.select.split(",")
                  if s.strip()]
        unknown = [w for w in wanted if w not in by_id]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        rules = [by_id[w] for w in wanted]

    try:
        findings = lint_paths(args.paths or list(DEFAULT_PATHS), rules)
    except LintError as e:
        print(f"tracelint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} entr"
              f"{'ies' if len(findings) != 1 else 'y'} to "
              f"{args.write_baseline}")
        return 0

    grandfathered = 0
    if args.baseline:
        try:
            fps = load_baseline(args.baseline)
        except LintError as e:
            print(f"tracelint: {e}", file=sys.stderr)
            return 2
        findings, grandfathered = apply_baseline(findings, fps)

    render = render_json if args.json else render_text
    print(render(findings, suppressed_by_baseline=grandfathered))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
