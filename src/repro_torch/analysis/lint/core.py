"""tracelint framework: findings, suppressions, rule base, the runner.

Port of ``repro/analysis/lint/core.py``.  Pure stdlib (``ast`` +
``tokenize``) on purpose: the linter reads the program text and never
executes it, so it runs in a bare container without torch, a card or
the package under analysis.  The pragma syntax, the finding fingerprint
and the suppression policy are the reference's, so one baseline file
reads the same under either linter.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional, Sequence

# `# tracelint: disable=TL001,TL003 -- justification`
# `# tracelint: disable-file=TL003 -- justification`
PRAGMA_RE = re.compile(
    r"#\s*tracelint:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9_,\s]+?)(?:\s*(?:--|—|:)\s*(.*))?$")

# the port's decision modules: the plain torch decision path that the
# CUDA enforcement kernels are held against bit for bit, and the kernels'
# wrappers; they admit no suppression pragma at all
DECISION_MODULES = ("core/progs.py", "core/sched.py", "core/controller.py",
                    "core/pressure.py", "kernels/enforcement.py")

META_RULE = "TL000"          # framework findings about suppressions


class LintError(Exception):
    """The linter itself could not proceed (bad path, bad baseline)."""


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to file:line:col."""
    rule: str
    path: str                # posix, as scanned (relative to the cwd)
    line: int
    col: int
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-independent identity used by the baseline: a finding
        survives unrelated edits shifting it up or down the file."""
        return f"{self.path}::{self.rule}::{self.message}"

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclass(frozen=True)
class Suppression:
    line: int                # line the pragma sits on
    rules: frozenset
    file_level: bool
    own_line: bool           # comment-only line: applies to the next line
    justification: str

    def covers(self, f: Finding) -> bool:
        if f.rule == META_RULE or f.rule not in self.rules:
            return False
        if self.file_level:
            return True
        if f.line == self.line:
            return True
        return self.own_line and f.line == self.line + 1


class FileContext:
    """One parsed source file: AST + suppressions + finding factory."""

    def __init__(self, path: str, source: str):
        self.path = Path(path).as_posix()
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=self.path)
        self.suppressions = _parse_suppressions(source)

    # ---------------------------------------------------------- scoping

    @property
    def segments(self) -> tuple:
        return tuple(Path(self.path).parts)

    def in_dirs(self, names: Iterable[str]) -> bool:
        return any(n in self.segments for n in names)

    def endswith(self, suffixes: Iterable[str]) -> bool:
        return any(self.path.endswith(s) for s in suffixes)

    @property
    def is_decision_module(self) -> bool:
        return self.endswith(DECISION_MODULES)

    # --------------------------------------------------------- findings

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


def _parse_suppressions(source: str) -> list:
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.start[1], t.string)
                    for t in tokens if t.type == tokenize.COMMENT]
    except tokenize.TokenizeError:
        return out
    lines = source.splitlines()
    for line, col, text in comments:
        m = PRAGMA_RE.match(text)
        if not m:
            continue
        kind, rule_list, justification = m.groups()
        rules = frozenset(r.strip().upper()
                          for r in rule_list.split(",") if r.strip())
        own = lines[line - 1][:col].strip() == ""
        out.append(Suppression(line=line, rules=rules,
                               file_level=(kind == "disable-file"),
                               own_line=own,
                               justification=(justification or "").strip()))
    return out


class Rule:
    """One invariant.  Subclasses set ``id``/``name``/``description``
    and implement ``check`` (per file) or, with ``project_wide=True``,
    ``check_project`` (once, over every scanned file — for cross-file
    invariants like protocol drift)."""

    id: str = "TL000"
    name: str = ""
    description: str = ""
    project_wide: bool = False

    def applies(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> list:
        return []

    def check_project(self, ctxs: Sequence[FileContext]) -> list:
        return []


# ------------------------------------------------------------------ runner


def _suppression_policy(ctx: FileContext, known_rules: set) -> list:
    """The pragmas themselves are checked: decision modules admit no
    suppressions at all, and every pragma must carry a justification."""
    out = []
    for s in ctx.suppressions:
        if ctx.is_decision_module:
            out.append(Finding(
                META_RULE, ctx.path, s.line, 0,
                "suppression pragma in decision-path module ("
                + ", ".join(DECISION_MODULES)
                + " must lint clean with zero suppressions)"))
        if not s.justification:
            out.append(Finding(
                META_RULE, ctx.path, s.line, 0,
                "suppression without justification (write "
                "'# tracelint: disable=TLxxx -- why it is safe')"))
        unknown = sorted(r for r in s.rules if r not in known_rules)
        if unknown:
            out.append(Finding(
                META_RULE, ctx.path, s.line, 0,
                f"suppression names unknown rule(s): {', '.join(unknown)}"))
    return out


def iter_py_files(paths: Iterable[str]) -> list:
    files = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
        else:
            raise LintError(f"not a python file or directory: {p}")
    return files


def lint_sources(sources: dict, rules: Optional[Sequence[Rule]] = None,
                 ) -> list:
    """Lint in-memory ``{path: source}`` pairs (the test harness entry
    point; ``lint_paths`` is the filesystem wrapper)."""
    from repro_torch.analysis.lint.rules import ALL_RULES
    rules = list(ALL_RULES) if rules is None else list(rules)
    known = {r.id for r in rules} | {META_RULE}
    ctxs, findings = [], []
    for path, src in sorted(sources.items()):
        try:
            ctxs.append(FileContext(path, src))
        except SyntaxError as e:
            findings.append(Finding(META_RULE, Path(path).as_posix(),
                                    e.lineno or 1, e.offset or 0,
                                    f"syntax error: {e.msg}"))
    for rule in rules:
        if rule.project_wide:
            findings.extend(rule.check_project(ctxs))
        else:
            for ctx in ctxs:
                if rule.applies(ctx):
                    findings.extend(rule.check(ctx))
    for ctx in ctxs:
        findings.extend(_suppression_policy(ctx, known))
    # apply pragma suppressions (never to TL000 — the policy above IS
    # the check on the pragmas)
    by_path = {c.path: c.suppressions for c in ctxs}
    kept = [f for f in findings
            if not any(s.covers(f) for s in by_path.get(f.path, ()))]
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[Rule]] = None) -> list:
    files = iter_py_files(paths)
    sources = {}
    for f in files:
        try:
            sources[str(f)] = f.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            raise LintError(f"cannot read {f}: {e}") from e
    return lint_sources(sources, rules)


# ------------------------------------------------------------ AST helpers


def qualname(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ('torch.cuda.synchronize'),
    None for anything dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_static_test(t: ast.AST, static_names: frozenset = frozenset()
                   ) -> bool:
    """Tests that cannot involve a tensor's value: identity checks
    (``x is None``), ``isinstance``/``hasattr``/``callable`` dispatch,
    constants, and boolean combinations thereof; with ``static_names``
    (locals known to hold Python containers), also those names,
    ``len(...)`` and
    comparisons among such operands.  Everything else in a
    decision scope is assumed to read a tensor."""
    if isinstance(t, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in t.ops):
            return True
        return all(static_operand(o, static_names)
                   for o in [t.left, *t.comparators])
    if isinstance(t, ast.Call):
        if qualname(t.func) in ("isinstance", "hasattr", "callable",
                                "issubclass"):
            return True
        return static_operand(t, static_names)
    if isinstance(t, ast.BoolOp):
        return all(is_static_test(v, static_names) for v in t.values)
    if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
        return is_static_test(t.operand, static_names)
    if isinstance(t, ast.Name):
        return t.id in static_names
    return isinstance(t, ast.Constant)


def static_operand(node: ast.AST, static_names: frozenset) -> bool:
    """A constant, a static name, or a ``len(...)`` (a length is a shape,
    never a tensor's value)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in static_names
    return (isinstance(node, ast.Call) and qualname(node.func) == "len"
            and len(node.args) == 1 and not node.keywords)
