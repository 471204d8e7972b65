"""Reporters: human text and machine JSON (port of
``repro/analysis/lint/report.py``, the same schema).

The JSON shape is stable (schema-checked in ``tests/test_torch_lint.py``)
because tooling parses it (``chip_smoke.py``'s lint phase reads it): ``{"version": 1, "findings": [...], "counts": {rule: n}, "total": N}``.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Sequence

from repro_torch.analysis.lint.core import Finding

REPORT_VERSION = 1


def render_text(findings: Sequence[Finding], *,
                suppressed_by_baseline: int = 0) -> str:
    lines = [f.format() for f in findings]
    counts = Counter(f.rule for f in findings)
    if findings:
        summary = ", ".join(f"{rule}: {n}"
                            for rule, n in sorted(counts.items()))
        lines.append("")
        lines.append(f"{len(findings)} finding"
                     f"{'s' if len(findings) != 1 else ''} ({summary})")
    else:
        lines.append("no findings")
    if suppressed_by_baseline:
        lines.append(f"({suppressed_by_baseline} grandfathered by baseline)")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], *,
                suppressed_by_baseline: int = 0) -> str:
    counts = Counter(f.rule for f in findings)
    payload = {
        "version": REPORT_VERSION,
        "findings": [f.to_dict() for f in findings],
        "counts": dict(sorted(counts.items())),
        "total": len(findings),
        "suppressed_by_baseline": suppressed_by_baseline,
    }
    return json.dumps(payload, indent=2)
