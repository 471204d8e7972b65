"""tracelint over the port — the static pass for the code the card runs.

Port of ``repro/analysis/lint``: the same framework (findings, the
``# tracelint: disable=<rule> -- why`` pragmas and their policy,
text/JSON reporters, the fingerprint baseline) and the same six
invariants, keyed to PyTorch and CUDA idioms instead of JAX's.  Pure
stdlib (``ast`` + ``tokenize``): it imports neither torch nor the
package it reads.  Run it from the root of a checkout as::

    python -m repro_torch.analysis.lint --baseline tracelint-baseline.json

(paths default to ``src/repro_torch`` and ``chip_smoke.py``).

Rules
-----
TL001  trace-purity       python if/while/assert on tensors, .item()/
                          .tolist()/.cpu()/.numpy(), casts, np.* and
                          synchronize in the decision scopes (the plain
                          torch bodies the CUDA kernels are held against)
TL002  retrace-hazard     python scalars closed over by torch.compile /
                          torch.jit / CUDA-graph captured code
TL003  replay-determinism wall clocks, unseeded entropy and torch's
                          process-global generator in core/ traces/
                          testing/
TL004  lock-discipline    inner-backend access outside the apply lock
TL005  protocol-drift     backend classes vs their own package's
                          ``Backend`` protocol
TL006  pytree-stability   conditionally-created control-state dict keys
"""
from repro_torch.analysis.lint.baseline import (apply_baseline, load_baseline,
                                                write_baseline)
from repro_torch.analysis.lint.core import (Finding, LintError, Rule,
                                            lint_paths, lint_sources)
from repro_torch.analysis.lint.report import render_json, render_text
from repro_torch.analysis.lint.rules import ALL_RULES, rules_by_id

__all__ = [
    "Finding", "LintError", "Rule", "lint_paths", "lint_sources",
    "ALL_RULES", "rules_by_id", "load_baseline", "write_baseline",
    "apply_baseline", "render_text", "render_json",
]
