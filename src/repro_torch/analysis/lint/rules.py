"""The tracelint rules over the port: the six invariants in torch idiom.

Port of ``repro/analysis/lint/rules.py``.  Each rule is the counterpart
of the reference rule with the same id; where the reference keys on a
JAX idiom (a traced root's name, ``jax.jit``, ``block_until_ready``),
this one keys on the port's torch and CUDA counterpart:

  TL001  the one decision path is the plain torch body that the CUDA
         enforcement kernels are held against bit for bit; a Python
         branch on a tensor's value forks it (and, on a CUDA tensor,
         syncs the device).  The roots are the port's decision entry
         points and plain bodies; the routing, checks and ctypes glue of
         ``kernels/enforcement.py`` stay outside them.
  TL002  a compiled or captured callable (``torch.compile``,
         ``torch.jit``, ``torch.cuda.make_graphed_callables``, a
         ``with torch.cuda.graph(...)`` block) bakes in the Python
         scalars it closes over, as a jit cache entry does.
  TL003  adds torch's process-global generator to the reference's
         wall clocks and unseeded entropy.
  TL004, TL006  the reference's AST logic unchanged.
  TL005  diffs each backend against the ``Backend`` protocol of its own
         package (the nearest protocol by path), so one scan of ``src``
         holds the port's backends to the port's protocol.

See ``tests/test_torch_lint.py`` for a seeded-violation / clean-twin
pair per check.
"""
from __future__ import annotations

import ast
import builtins
from pathlib import PurePosixPath
from typing import Optional

from repro_torch.analysis.lint.core import (FileContext, Rule,
                                            is_static_test, qualname,
                                            static_operand)

_BUILTINS = frozenset(dir(builtins))

# program classes: the memcg_bpf_ops analogues whose hooks every backend
# runs (core/progs.py, core/sched.py) — subclasses anywhere inherit the
# purity obligation
PROGRAM_BASES = frozenset({
    "PolicyProgram", "GraduatedThrottleProgram", "TokenBucketProgram",
    "WeightedFairProgram",
})
TRACED_HOOKS = frozenset({"on_charge", "on_over_high", "on_gate",
                          "on_schedule"})
# module-level decision entry points in the decision modules: the plain
# torch decision path every backend kind runs and the CUDA kernels are
# held against.  ``_plain_*`` are the counterparts of the reference's
# ``_lax_charge_batch``/``_lax_slot_gate``; ``fused_*`` are the kernel
# wrappers' entry points.  Device routing, shape checks and the ctypes
# glue below them (``_charge_route``, ``charge_checks``, ``charge_call``,
# ...) are deliberately NOT roots: they read metadata, never a value.
TRACED_FUNCS = frozenset({
    "charge_decision", "schedule_decision", "charge_batch", "slot_gate",
    "uncharge_batch", "_chain_view", "_ancestor_chain",
    "charge_stall_event", "sched_stall_events", "saturating_count",
    "_decision_one", "gate_decision", "schedule_weight",
    "fused_charge_batch", "fused_slot_gate",
    "_plain_charge_batch", "_plain_slot_gate",
    "_plain_charge_shards", "_plain_gate_shards",
})
# displays whose truthiness is their length, never a tensor's value
_CONTAINERS = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp,
               ast.SetComp, ast.DictComp)


def _is_program_class(node: ast.ClassDef) -> bool:
    if node.name in PROGRAM_BASES:
        return True
    for base in node.bases:
        q = qualname(base)
        if q is not None and q.split(".")[-1] in PROGRAM_BASES:
            return True
    return any(isinstance(m, ast.FunctionDef) and m.name in TRACED_HOOKS
               for m in node.body)


def static_names(fn: ast.FunctionDef) -> frozenset:
    """Locals of ``fn`` every binding of which is a container display or
    comprehension: a list of per-slot tensors is tested by its length.
    A parameter, or any other binding of a name (a loop target, a
    non-container assignment), may hold a tensor and is never static."""
    containers = set()
    a = fn.args
    other = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    for n in ast.walk(fn):
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                for name, value in _bindings(t, n.value):
                    (containers if isinstance(value, _CONTAINERS)
                     else other).add(name)
        elif isinstance(n, (ast.For, ast.comprehension)):
            other.update(_names(n.target))
        elif isinstance(n, ast.NamedExpr):
            other.add(n.target.id)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            other.update(_names(n.optional_vars))
    return frozenset(containers - other)


def _names(target) -> set:
    return {x.id for x in ast.walk(target) if isinstance(x, ast.Name)}


def _bindings(target, value):
    """``(name, value node or None)`` for each name an assignment binds;
    ``a, b = [], []`` pairs each name with its own display."""
    if isinstance(target, ast.Name):
        return [(target.id, value)]
    if (isinstance(target, (ast.Tuple, ast.List))
            and isinstance(value, (ast.Tuple, ast.List))
            and len(target.elts) == len(value.elts)):
        return [b for t, v in zip(target.elts, value.elts)
                for b in _bindings(t, v)]
    return [(name, None) for name in _names(target)]


class TracePurity(Rule):
    """TL001: no Python branch on a tensor's value, no host read and no
    host sync inside the decision scopes.  The plain torch body is the
    spec the CUDA kernels are held against bit for bit: a Python ``if``
    on a tensor forks that one decision path on a value (and syncs the
    card to read it), so the kernel and its spec stop computing the same
    function.  The eBPF verifier rejects unverifiable branches for the
    same reason."""

    id = "TL001"
    name = "trace-purity"
    description = ("python if/while/assert on tensors, .item()/.tolist()/"
                   ".cpu()/.numpy(), float()/int() casts, np.* calls and "
                   "synchronize in decision scopes")

    CASTS = frozenset({"float", "int", "bool", "complex"})
    # methods that read a tensor back to the host (a sync on CUDA)
    HOST_READS = frozenset({"item", "tolist", "cpu", "numpy"})
    # explicit syncs: poison anywhere in a decision module, as
    # ``block_until_ready``/``device_get`` are in the reference
    HOST_SYNCS = frozenset({"synchronize"})

    def applies(self, ctx: FileContext) -> bool:
        return ctx.is_decision_module or any(
            isinstance(n, ast.ClassDef) and _is_program_class(n)
            for n in ast.walk(ctx.tree))

    # ---------------------------------------------------- decision scopes

    def _traced_roots(self, ctx: FileContext) -> list:
        roots = []
        for node in ctx.tree.body:
            if (isinstance(node, ast.FunctionDef)
                    and ctx.is_decision_module
                    and node.name in TRACED_FUNCS):
                roots.append(node)
            elif isinstance(node, ast.ClassDef) and _is_program_class(node):
                for m in node.body:
                    if (isinstance(m, ast.FunctionDef)
                            and m.name in (TRACED_HOOKS | {"delay_ms"})):
                        roots.append(m)
        return roots

    def check(self, ctx: FileContext) -> list:
        out = []
        for root in self._traced_roots(ctx):
            static = static_names(root)
            for node in ast.walk(root):
                out.extend(self._check_node(ctx, node, root.name, static))
        if ctx.is_decision_module:
            # an explicit sync anywhere in a decision module means the
            # decision path depends on a device round trip
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Attribute)
                        and node.attr in self.HOST_SYNCS):
                    out.append(ctx.finding(
                        self.id, node,
                        f"host sync '{node.attr}' in decision-path module"))
        return out

    def _check_node(self, ctx, node, scope, static) -> list:
        out = []
        if isinstance(node, (ast.If, ast.While)):
            if not is_static_test(node.test, static):
                kw = "if" if isinstance(node, ast.If) else "while"
                out.append(ctx.finding(
                    self.id, node,
                    f"python '{kw}' on a potentially-tensor value in "
                    f"decision scope '{scope}' (use torch.where — a python "
                    "branch forks the one decision path and syncs the "
                    "card)"))
        elif isinstance(node, ast.IfExp):
            if not is_static_test(node.test, static):
                out.append(ctx.finding(
                    self.id, node,
                    f"python conditional expression in decision scope "
                    f"'{scope}' (use torch.where)"))
        elif isinstance(node, ast.Assert):
            if not is_static_test(node.test, static):
                out.append(ctx.finding(
                    self.id, node,
                    f"python 'assert' on a tensor in decision scope "
                    f"'{scope}' (it syncs the card, and vanishes under "
                    "-O; check shapes host-side or use torch._assert_async)"))
        elif isinstance(node, ast.Call):
            q = qualname(node.func)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            if attr in self.HOST_READS:
                out.append(ctx.finding(
                    self.id, node,
                    f".{attr}() host read in decision scope '{scope}' "
                    "(reads the tensor back to the host: a sync on the "
                    "card)"))
            elif (q in self.CASTS and node.args
                  and not all(static_operand(a, static)
                              for a in node.args)):
                out.append(ctx.finding(
                    self.id, node,
                    f"{q}() cast in decision scope '{scope}' forces a host "
                    "sync on a tensor (use .to(dtype))"))
            elif q is not None and q.split(".")[0] in ("np", "numpy"):
                out.append(ctx.finding(
                    self.id, node,
                    f"numpy call '{q}' in decision scope '{scope}' "
                    "(silently copies tensors to the host; use torch)"))
            elif attr in self.HOST_SYNCS:
                out.append(ctx.finding(
                    self.id, node,
                    f"host sync '{attr}' in decision scope '{scope}'"))
        return out


class RetraceHazards(Rule):
    """TL002: Python scalars closed over by compiled or captured
    callables.  ``torch.compile`` guards on a closed-over scalar and
    recompiles for each new value; ``torch.jit`` and a CUDA graph bake it
    in, so a capture replays the value it saw.  A retune that should be
    a param-table write (the zero-retrace contract ``update_params``
    promises) then recompiles or, under a graph, replays stale.
    Retunable values belong in the program param table (a tensor), and
    a step count in a device tensor the graph reads."""

    id = "TL002"
    name = "retrace-hazard"
    description = ("python scalars (or loop variables) closed over by "
                   "torch.compile/torch.jit/CUDA-graph captured code")

    COMPILE_NAMES = frozenset({
        "torch.compile", "torch.jit.script", "torch.jit.trace",
        "torch.cuda.make_graphed_callables"})
    GRAPH_CONTEXTS = frozenset({"torch.cuda.graph"})

    def applies(self, ctx: FileContext) -> bool:
        return ctx.in_dirs(("core",)) or ctx.is_decision_module

    def check(self, ctx: FileContext) -> list:
        out = []
        self._walk(ctx, ctx.tree, [], out)
        return out

    def _walk(self, ctx, node, stack, out) -> None:
        for child in ast.iter_child_nodes(node):
            if stack:
                if (isinstance(child, ast.Call)
                        and qualname(child.func) in self.COMPILE_NAMES):
                    self._check_compile_call(ctx, child, stack, out)
                elif isinstance(child, (ast.With, ast.AsyncWith)) and any(
                        isinstance(i.context_expr, ast.Call)
                        and qualname(i.context_expr.func)
                        in self.GRAPH_CONTEXTS for i in child.items):
                    self._check_capture(ctx, child, stack, out)
                if (isinstance(child, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                        and any(qualname(d.func if isinstance(d, ast.Call)
                                         else d) in self.COMPILE_NAMES
                                for d in child.decorator_list)):
                    self._report(ctx, child, child, stack, out)
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                self._walk(ctx, child, stack + [child], out)
            else:
                self._walk(ctx, child, stack, out)

    def _check_compile_call(self, ctx, call, stack, out) -> None:
        if not call.args:
            return
        target = call.args[0]
        targets = (target.elts if isinstance(target, (ast.Tuple, ast.List))
                   else [target])
        for t in targets:
            fn = None
            if isinstance(t, ast.Lambda):
                fn = t
            elif isinstance(t, ast.Name):
                # a local def referenced by name; module-level defs have
                # no enclosing python frame to close over
                for scope in reversed(stack):
                    for n in ast.walk(scope):
                        if (isinstance(n, ast.FunctionDef)
                                and n.name == t.id):
                            fn = n
                            break
                    if fn is not None:
                        break
            if fn is not None:
                self._report(ctx, call, fn, stack, out)

    def _report(self, ctx, at, fn, stack, out) -> None:
        for name in sorted(_free_names(fn)):
            verdict = _closure_binding_hazard(name, stack)
            if verdict is not None:
                out.append(ctx.finding(
                    self.id, at,
                    f"compiled callable closes over '{name}' ({verdict}); "
                    "pass it as a tensor argument or move it into the "
                    "program param table so retunes stay zero-retrace"))

    def _check_capture(self, ctx, block, stack, out) -> None:
        """Names a ``with torch.cuda.graph(...)`` body reads that the
        enclosing function binds as a loop variable or a Python scalar:
        the captured kernels replay the value seen at capture."""
        bound, loads = set(), set()
        for stmt in block.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name):
                    (bound if isinstance(n.ctx, (ast.Store, ast.Del))
                     else loads).add(n.id)
        for name in sorted(loads - bound - _BUILTINS):
            verdict = _closure_binding_hazard(name, stack)
            if verdict is not None:
                out.append(ctx.finding(
                    self.id, block,
                    f"CUDA graph capture reads '{name}' ({verdict}); the "
                    "graph replays the value seen at capture — keep it in "
                    "a device tensor the graph reads"))


def _free_names(fn) -> set:
    """Names loaded in ``fn`` but bound neither locally nor as params
    (builtins excluded) — the closure surface."""
    bound, loads = set(), set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        bound.add(a.arg)
    for a in (args.vararg, args.kwarg):
        if a is not None:
            bound.add(a.arg)
    for n in ast.walk(fn):
        if isinstance(n, ast.Name):
            (bound if isinstance(n.ctx, (ast.Store, ast.Del))
             else loads).add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            if n is not fn:
                bound.add(n.name)
        elif isinstance(n, ast.Lambda) and n is not fn:
            la = n.args
            for a in (la.posonlyargs + la.args + la.kwonlyargs):
                bound.add(a.arg)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for alias in n.names:
                bound.add((alias.asname or alias.name).split(".")[0])
    return loads - bound - _BUILTINS


def _scalar_like(node) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool, complex))
    if isinstance(node, ast.Call):
        return qualname(node.func) in ("int", "float", "bool", "len")
    if isinstance(node, ast.BinOp):
        return _scalar_like(node.left) or _scalar_like(node.right)
    if isinstance(node, ast.UnaryOp):
        return _scalar_like(node.operand)
    return False


def _closure_binding_hazard(name, stack) -> Optional[str]:
    """How ``name`` is bound in the enclosing function scopes, innermost
    first; returns a hazard description or None when the binding looks
    safe (an object reference like ``prog = self.prog``, whose identity
    IS the compiled code) or is module-global."""
    for scope in reversed(stack):
        if isinstance(scope, ast.Lambda):
            continue
        for n in ast.walk(scope):
            if isinstance(n, ast.For):
                targets = [t.id for t in ast.walk(n.target)
                           if isinstance(t, ast.Name)]
                if name in targets:
                    return ("bound as a loop variable — one compiled "
                            "entry or one stale capture per iteration")
            elif isinstance(n, ast.Assign):
                targets = [t.id for t in n.targets
                           if isinstance(t, ast.Name)]
                if name in targets and _scalar_like(n.value):
                    return "a python scalar baked in as a constant"
            elif isinstance(n, ast.AnnAssign):
                if (isinstance(n.target, ast.Name) and n.target.id == name
                        and n.value is not None
                        and _scalar_like(n.value)):
                    return "a python scalar baked in as a constant"
    return None


class ReplayDeterminism(Rule):
    """TL003: no wall clocks or unseeded entropy on the record/replay
    path.  ``fig8_replay`` is bit-identical run to run — one
    ``time.time()`` stamped into a state record, or one draw from
    torch's process-global generator, breaks snapshot stability and
    replay equality probabilistically, which no parity test catches
    until it flakes.  ``time.monotonic``/``time.sleep`` stay legal:
    they shape wall-clock behaviour (timeouts, injected delays), never
    recorded state.  Random draws take an explicit generator
    (``torch.Generator().manual_seed(seed)``, ``np.random.default_rng``).

    The ``launch``/``benchmarks`` allowlist is for *measurement*, not a
    license for wall clocks in recorded state: timing code there must
    still use ``time.perf_counter()`` rather than ``time.time()``."""

    id = "TL003"
    name = "replay-determinism"
    description = ("time.time/datetime.now/os.urandom/stdlib random/"
                   "unseeded np.random/torch's global generator in core/, "
                   "traces/, testing/")

    SCOPE_DIRS = ("core", "traces", "testing")
    ALLOW_DIRS = ("launch", "benchmarks")
    DATETIME_FNS = frozenset({"now", "utcnow", "today"})
    NP_RANDOM_OK = frozenset({"default_rng", "SeedSequence", "Generator",
                              "PCG64", "Philox"})
    # torch draws that fall back to the process-global generator unless
    # given ``generator=``
    TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                             "normal", "bernoulli", "multinomial"})
    INPLACE_DRAWS = frozenset({"uniform_", "normal_", "bernoulli_",
                               "random_", "exponential_", "cauchy_",
                               "log_normal_", "geometric_"})
    # seeding (or reseeding) the process-global generators
    TORCH_SEEDS = frozenset({
        "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
        "torch.random.seed", "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all", "torch.cuda.seed",
        "torch.cuda.seed_all"})

    def applies(self, ctx: FileContext) -> bool:
        return (ctx.in_dirs(self.SCOPE_DIRS)
                and not ctx.in_dirs(self.ALLOW_DIRS))

    def check(self, ctx: FileContext) -> list:
        out = []
        # `from time import time` / `from random import ...` defeat the
        # attribute checks below — ban the import form itself
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "time" and any(
                        a.name == "time" for a in node.names):
                    out.append(ctx.finding(
                        self.id, node,
                        "'from time import time' — wall clock on the "
                        "replay path (use the facade/step clock)"))
                if node.module == "random":
                    out.append(ctx.finding(
                        self.id, node,
                        "'from random import ...' — unseeded global RNG "
                        "on the replay path (use np.random.default_rng"
                        "(seed))"))
            q = qualname(node) if isinstance(node, ast.Attribute) else None
            if q == "time.time":
                out.append(ctx.finding(
                    self.id, node,
                    "time.time() — wall clock stamped on the replay path "
                    "(use the facade/step clock passed by the caller)"))
            elif q in ("os.urandom",):
                out.append(ctx.finding(
                    self.id, node,
                    "os.urandom — entropy on the replay path"))
            elif (q is not None and q.startswith("datetime.")
                  and q.split(".")[-1] in self.DATETIME_FNS):
                out.append(ctx.finding(
                    self.id, node,
                    f"{q}() — wall clock on the replay path"))
            elif (q is not None and q.startswith("random.")
                  and q.count(".") == 1):
                fn = q.split(".")[-1]
                if fn != "Random":
                    out.append(ctx.finding(
                        self.id, node,
                        f"stdlib {q} — process-global RNG on the replay "
                        "path (use np.random.default_rng(seed))"))
            if isinstance(node, ast.Call):
                out.extend(self._check_call(ctx, node))
        return out

    def _check_call(self, ctx, node) -> list:
        fq = qualname(node.func)
        if fq in ("np.random.default_rng", "numpy.random.default_rng"):
            if not node.args and not node.keywords:
                return [ctx.finding(
                    self.id, node,
                    "np.random.default_rng() without a seed — "
                    "entropy on the replay path")]
        elif (fq is not None
              and (fq.startswith("np.random.")
                   or fq.startswith("numpy.random."))
              and fq.split(".")[-1] not in self.NP_RANDOM_OK):
            return [ctx.finding(
                self.id, node,
                f"legacy global-state '{fq}' on the replay path "
                "(use a seeded np.random.default_rng)")]
        elif fq in self.TORCH_SEEDS:
            return [ctx.finding(
                self.id, node,
                f"{fq}() seeds torch's process-global generator on the "
                "replay path (use an explicit torch.Generator)")]
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        if has_gen:
            return []
        if (fq is not None and fq.startswith("torch.")
                and fq.count(".") == 1
                and fq.split(".")[-1] in self.TORCH_DRAWS):
            return [ctx.finding(
                self.id, node,
                f"{fq}() without generator= draws from torch's "
                "process-global generator on the replay path")]
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in self.INPLACE_DRAWS):
            return [ctx.finding(
                self.id, node,
                f".{node.func.attr}() without generator= draws from "
                "torch's process-global generator on the replay path")]
        return []


class LockDiscipline(Rule):
    """TL004: inner-backend access outside the apply lock.  The async
    daemon's correctness argument is 'readers observe whole epochs':
    every ``self.inner`` touch outside ``with self._apply_lock`` (or a
    callable run under it via ``_observe``) can see a batch
    mid-application — the race the epoch tag exists to prevent."""

    id = "TL004"
    name = "lock-discipline"
    description = ("inner-backend attribute access outside a "
                   "'with self._apply_lock' block (async daemon classes)")

    MODULES = ("core/daemon.py", "core/faults.py")
    INNER_NAMES = ("inner", "_inner")
    EXEMPT_METHODS = frozenset({"__init__", "_observe"})

    def applies(self, ctx: FileContext) -> bool:
        return ctx.endswith(self.MODULES)

    def check(self, ctx: FileContext) -> list:
        out = []
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx, cls) -> list:
        init = next((m for m in cls.body if isinstance(m, ast.FunctionDef)
                     and m.name == "__init__"), None)
        if init is None:
            return []
        assigned = _self_stores(init)
        # lock discipline only binds classes that HAVE the lock: a
        # synchronous single-writer wrapper (FaultyBackend) has no
        # epochs to protect
        if "_apply_lock" not in assigned:
            return []
        inner = next((n for n in self.INNER_NAMES if n in assigned), None)
        if inner is None:
            return []
        out = []
        for m in cls.body:
            if (isinstance(m, ast.FunctionDef)
                    and m.name not in self.EXEMPT_METHODS):
                out.extend(self._check_method(ctx, m, inner))
        return out

    def _observe_callables(self, method) -> set:
        """Callables executed under the lock by ``self._observe``:
        lambda/def arguments plus local defs passed by name."""
        passed = set()
        for n in ast.walk(method):
            if (isinstance(n, ast.Call)
                    and qualname(n.func) == "self._observe"):
                for a in n.args:
                    if isinstance(a, (ast.Lambda, ast.FunctionDef)):
                        passed.add(id(a))
                    elif isinstance(a, ast.Name):
                        passed.add(a.id)
        locked = set()
        for n in ast.walk(method):
            if isinstance(n, ast.Lambda) and id(n) in passed:
                locked.add(n)
            elif (isinstance(n, ast.FunctionDef)
                  and (id(n) in passed or n.name in passed)):
                locked.add(n)
        return locked

    def _check_method(self, ctx, method, inner) -> list:
        locked_fns = self._observe_callables(method)
        out = []

        def is_lock_with(stmt) -> bool:
            return isinstance(stmt, ast.With) and any(
                qualname(item.context_expr) == "self._apply_lock"
                for item in stmt.items)

        def visit(node, locked):
            if node in locked_fns:
                locked = True
            if is_lock_with(node):
                locked = True
            if (not locked and isinstance(node, ast.Attribute)
                    and node.attr == inner
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and isinstance(node.ctx, ast.Load)):
                out.append(ctx.finding(
                    self.id, node,
                    f"self.{inner} accessed outside 'with "
                    "self._apply_lock' — a reader here can observe an "
                    "epoch mid-application (route it through "
                    "self._observe)"))
            for child in ast.iter_child_nodes(node):
                visit(child, locked)

        visit(method, False)
        return out


def _self_stores(fn) -> set:
    """Attributes ``fn`` assigns on ``self``."""
    return {n.attr for n in ast.walk(fn)
            if isinstance(n, ast.Attribute)
            and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name)
            and n.value.id == "self"}


class ProtocolDrift(Rule):
    """TL005: backend classes vs the ``Backend`` protocol, statically.
    Conformance certifies the ops a scenario happens to exercise; a
    missing method or drifted signature on a rarely-hit op (kill during
    rmdir races) surfaces only in production.  This diff is total.

    Each backend is held to the protocol of its own package: of the
    protocols scanned, the one whose file shares the longest directory
    prefix with the backend's (the first in path order on a tie), so
    a scan of ``src`` diffs ``src/repro_torch``'s backends against
    ``src/repro_torch/core/cgroup.py::Backend``, not the reference's."""

    id = "TL005"
    name = "protocol-drift"
    description = ("backend classes missing protocol methods, carrying "
                   "signature mismatches, or growing unsanctioned surface")
    project_wide = True

    PROTOCOL_CLASS = "Backend"
    # sanctioned extensions beyond the protocol (each is documented on
    # the class that carries it); anything else is drift until either
    # added here deliberately or promoted into the protocol
    EXTENSIONS = frozenset({
        "device_view", "restore", "flush", "barrier", "close",
        "throttle_delay_ms", "reconcile", "unwedge", "placement",
        "offload_fault",
    })

    def check_project(self, ctxs) -> list:
        classes = [(ctx, [n for n in ast.walk(ctx.tree)
                          if isinstance(n, ast.ClassDef)]) for ctx in ctxs]
        protos = []
        for ctx, defs in classes:
            proto = next((n for n in defs
                          if n.name == self.PROTOCOL_CLASS
                          and any((qualname(b) or "").endswith("Protocol")
                                  for b in n.bases)), None)
            if proto is not None:
                protos.append((ctx.path, _protocol_surface(proto)))
        if not protos:
            return []
        out = []
        for ctx, defs in classes:
            backends = [n for n in defs
                        if n.name.endswith("Backend")
                        and n.name != self.PROTOCOL_CLASS
                        and not _is_exception(n)]
            if backends:
                methods, attrs = _nearest(ctx.path, protos)
                for node in backends:
                    out.extend(self._check_backend(ctx, node, methods,
                                                   attrs))
        return out

    def _check_backend(self, ctx, cls, methods, attrs) -> list:
        defined = {m.name: m for m in cls.body
                   if isinstance(m, ast.FunctionDef)}
        has_getattr = "__getattr__" in defined
        out = []
        for name, want in sorted(methods.items()):
            if name not in defined:
                if not has_getattr:
                    out.append(ctx.finding(
                        self.id, cls,
                        f"{cls.name} is missing Backend method "
                        f"'{name}{_fmt(want)}'"))
                continue
            got = _sig(defined[name])
            if got is not None and want is not None and got != want:
                out.append(ctx.finding(
                    self.id, defined[name],
                    f"{cls.name}.{name}{_fmt(got)} drifts from the "
                    f"Backend protocol {_fmt(want)}"))
        for name, m in sorted(defined.items()):
            if (name.startswith("_") or name in methods
                    or name in self.EXTENSIONS
                    or _is_property(m)):
                continue
            out.append(ctx.finding(
                self.id, m,
                f"{cls.name}.{name} is not in the Backend protocol nor "
                "the sanctioned extension list (promote it or rename it "
                "to a private helper)"))
        if not has_getattr:
            init = defined.get("__init__")
            assigned = _self_stores(init) if init is not None else set()
            props = {m.name for m in cls.body
                     if isinstance(m, ast.FunctionDef) and _is_property(m)}
            class_assigns = {t.id for s in cls.body
                             if isinstance(s, ast.Assign)
                             for t in s.targets
                             if isinstance(t, ast.Name)}
            for a in sorted(attrs):
                if a not in assigned | props | class_assigns:
                    out.append(ctx.finding(
                        self.id, cls,
                        f"{cls.name} does not provide Backend attribute "
                        f"'{a}'"))
        return out


def _protocol_surface(proto: ast.ClassDef) -> tuple:
    """``(methods {name: signature}, attributes)`` of a protocol."""
    methods = {m.name: _sig(m) for m in proto.body
               if isinstance(m, ast.FunctionDef)
               and not m.name.startswith("_")}
    attrs = {s.target.id for s in proto.body
             if isinstance(s, ast.AnnAssign)
             and isinstance(s.target, ast.Name)}
    return methods, attrs


def _nearest(path: str, protos: list) -> tuple:
    """The surface of the protocol whose file shares the longest
    directory prefix with ``path``; the first scanned on a tie."""
    where = PurePosixPath(path).parent.parts

    def shared(proto_path: str) -> int:
        n = 0
        for a, b in zip(where, PurePosixPath(proto_path).parent.parts):
            if a != b:
                break
            n += 1
        return n

    return max(protos, key=lambda p: shared(p[0]))[1]


def _sig(fn) -> Optional[tuple]:
    a = fn.args
    if a.vararg is not None or a.kwarg is not None:
        return None                    # dynamic signature: can't compare
    names = tuple(x.arg for x in (a.posonlyargs + a.args))
    return names[1:] if names and names[0] in ("self", "cls") else names


def _fmt(sig) -> str:
    return "(...)" if sig is None else f"({', '.join(sig)})"


def _is_exception(cls) -> bool:
    return any((qualname(b) or "").endswith(("Error", "Exception"))
               for b in cls.bases)


def _is_property(fn) -> bool:
    for d in fn.decorator_list:
        q = qualname(d)
        if q == "property" or (q is not None and q.endswith(".setter")):
            return True
    return False


class PytreeStability(Rule):
    """TL006: conditionally-created dict keys in control-state builders.
    The state dict is a fixed set of columns: the kernels' wrappers
    check every column they read, snapshots and the sharded stack map
    over its keys, and a capture would key on its structure.  A dict
    that sometimes carries a key and sometimes doesn't breaks all three
    on the flip — and snapshot/restore across the flip silently drops
    state.  Keys must exist unconditionally (use a neutral value
    instead of absence)."""

    id = "TL006"
    name = "pytree-stability"
    description = ("dict keys created under a conditional in functions "
                   "building control-state pytrees")

    def applies(self, ctx: FileContext) -> bool:
        return ctx.in_dirs(("core",))

    def check(self, ctx: FileContext) -> list:
        out = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_fn(ctx, node, out)
        return out

    def _check_fn(self, ctx, fn, out) -> None:
        tracked: dict = {}

        def literal_keys(value) -> Optional[set]:
            if isinstance(value, ast.Dict):
                keys = set()
                for k in value.keys:
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        keys.add(k.value)
                    else:
                        return None     # **spread / computed key: opaque
                return keys
            if (isinstance(value, ast.Call)
                    and qualname(value.func) == "dict"
                    and not value.args):
                return {kw.arg for kw in value.keywords
                        if kw.arg is not None}
            return None

        def visit(stmts, depth) -> None:
            for s in stmts:
                if isinstance(s, ast.Assign) and len(s.targets) == 1:
                    t = s.targets[0]
                    if isinstance(t, ast.Name):
                        keys = literal_keys(s.value)
                        if keys is not None and depth == 0:
                            tracked[t.id] = keys
                        else:
                            tracked.pop(t.id, None)
                    elif (isinstance(t, ast.Subscript)
                          and isinstance(t.value, ast.Name)
                          and t.value.id in tracked
                          and isinstance(t.slice, ast.Constant)
                          and isinstance(t.slice.value, str)):
                        key = t.slice.value
                        if key in tracked[t.value.id]:
                            pass
                        elif depth > 0:
                            out.append(ctx.finding(
                                self.id, s,
                                f"dict key '{key}' created conditionally "
                                f"on '{t.value.id}' — pytree structure "
                                "now depends on runtime state (create "
                                "the key unconditionally with a neutral "
                                "value)"))
                        else:
                            tracked[t.value.id].add(key)
                for child, extra in _nested_blocks(s):
                    visit(child, depth + extra)

        visit(fn.body, 0)

    # note: nested function defs inside `fn` get their own _check_fn
    # pass via ast.walk in check(), so we skip them here


def _nested_blocks(stmt):
    """(body, conditional-depth-delta) pairs for compound statements.
    ``for``/``with`` bodies are not conditional structure-wise (the same
    keys are set each iteration); ``if``/``while``/``try`` are."""
    if isinstance(stmt, ast.If):
        return [(stmt.body, 1), (stmt.orelse, 1)]
    if isinstance(stmt, ast.While):
        return [(stmt.body, 1), (stmt.orelse, 1)]
    if isinstance(stmt, ast.Try):
        blocks = [(stmt.body, 1), (stmt.orelse, 1), (stmt.finalbody, 0)]
        blocks.extend((h.body, 1) for h in stmt.handlers)
        return blocks
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [(stmt.body, 0), (stmt.orelse, 1)]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [(stmt.body, 0)]
    return []


ALL_RULES = (TracePurity(), RetraceHazards(), ReplayDeterminism(),
             LockDiscipline(), ProtocolDrift(), PytreeStability())


def rules_by_id() -> dict:
    return {r.id: r for r in ALL_RULES}
