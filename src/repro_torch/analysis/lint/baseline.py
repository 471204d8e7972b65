"""Baseline handling: grandfathered findings, by fingerprint.

Port of ``repro/analysis/lint/baseline.py``, the same format (version
1), so one ``tracelint-baseline.json`` serves both linters.

The baseline is a checked-in JSON file of finding fingerprints
(``path::rule::message`` — deliberately line-independent, so unrelated
edits shifting code up or down a file do not invalidate it).  CI runs
with ``--baseline``: any finding not in the file fails the build, which
ratchets the codebase toward clean without blocking on a big-bang fix.
The checked-in ``tracelint-baseline.json`` is empty: both packages lint
clean under their own linters, so the file is the ratchet's anchor.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Sequence

from repro_torch.analysis.lint.core import Finding, LintError

BASELINE_VERSION = 1


def load_baseline(path: str) -> frozenset:
    """Read a baseline file into a set of fingerprints."""
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except FileNotFoundError:
        raise LintError(f"baseline file not found: {path}") from None
    except (OSError, json.JSONDecodeError) as e:
        raise LintError(f"cannot read baseline {path}: {e}") from e
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION:
        raise LintError(f"unsupported baseline format in {path}")
    entries = data.get("entries", [])
    fps = set()
    for e in entries:
        try:
            fps.add(f"{e['path']}::{e['rule']}::{e['message']}")
        except (TypeError, KeyError):
            raise LintError(f"malformed baseline entry in {path}: {e!r}"
                            ) from None
    return frozenset(fps)


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Write the current findings out as the new baseline."""
    entries = sorted(
        ({"path": f.path, "rule": f.rule, "message": f.message}
         for f in findings),
        key=lambda e: (e["path"], e["rule"], e["message"]))
    payload = {"version": BASELINE_VERSION, "entries": entries}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n",
                          encoding="utf-8")


def apply_baseline(findings: Sequence[Finding],
                   fingerprints: frozenset) -> tuple:
    """Split findings against a baseline: ``(kept, suppressed_count)``.
    Kept findings are new relative to the baseline and should fail CI."""
    kept = [f for f in findings if f.fingerprint not in fingerprints]
    return kept, len(findings) - len(kept)
