"""tracelint over the port (``repro_torch.analysis.lint``): a twin of every
case of ``tests/test_lint.py``; the reference's fixtures through both
linters, which must agree on ``(rule, path, line, col)`` for TL000,
TL003-TL006 and the framework; a seeded-violation / clean-twin pair in
torch idiom for each check of TL001, TL002 and TL003's torch generator;
the TL005 two-package scan; and the self-run (the port lints clean, its
decision modules hold no pragma, the JAX linter over ``src`` still
exits 0).  The linter itself needs no torch."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from repro.analysis import lint as ref_lint                       # noqa: E402
from repro.analysis.lint.cli import main as ref_cli               # noqa: E402
from repro_torch.analysis.lint import (apply_baseline,            # noqa: E402
                                       lint_paths, lint_sources,
                                       load_baseline, render_json,
                                       render_text, rules_by_id,
                                       write_baseline)
from repro_torch.analysis.lint.cli import main as cli_main        # noqa: E402
from repro_torch.analysis.lint.core import DECISION_MODULES       # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BASELINE = str(REPO / "tracelint-baseline.json")


def sources_of(path, src, **more):
    sources = {path: textwrap.dedent(src)}
    for p, s in more.items():
        sources[p] = textwrap.dedent(s)
    return sources


def lint(path, src, **more):
    return lint_sources(sources_of(path, src, **more))


def rules_fired(findings):
    return {f.rule for f in findings}


def keys(findings):
    return [(f.rule, f.path, f.line, f.col) for f in findings]


# ------------------------------------------- the reference's fixtures, shared
#
# Each case: ({path: source}, a check on the port's findings).  Both
# linters must report the same (rule, path, line, col) on the sources.


PROTO = """\
    from typing import Protocol

    class Backend(Protocol):
        log: int

        def read(self, path, file): ...
        def write(self, path, file, value): ...
    """

BAD_CORE = """\
    import time

    def stamp():
        return time.time()
    """


def _tl003_wall_clock(fs):
    msgs = [f.message for f in fs]
    assert all(f.rule == "TL003" for f in fs)
    assert any("time.time()" in m for m in msgs)
    assert any("os.urandom" in m for m in msgs)
    assert any("random.random" in m for m in msgs)
    assert any("without a seed" in m for m in msgs)
    assert any("np.random.rand" in m for m in msgs)


def _tl005_missing(fs):
    msgs = [f.message for f in fs]
    assert all(f.rule == "TL005" for f in fs)
    assert any("missing Backend method 'write" in m for m in msgs)
    assert any("drifts from the Backend protocol" in m for m in msgs)


def _tl005_surface(fs):
    msgs = [f.message for f in fs]
    assert any("frobnicate is not in the Backend protocol" in m
               for m in msgs)
    assert any("does not provide Backend attribute 'log'" in m
               for m in msgs)


def _tl003_import_forms(fs):
    assert len(fs) == 2
    assert rules_fired(fs) == {"TL003"}


def _in_decision_module(fs):
    assert any(f.rule == "TL000" and "decision-path module" in f.message
               for f in fs)


def _only(rule, *words):
    def check(fs):
        assert rules_fired(fs) == {rule}
        for w in words:
            assert w in fs[0].message
    return check


def _clean(fs):
    assert fs == []


SHARED = {
    "tl003_wall_clock_and_entropy": (sources_of("core/rec.py", """\
        import os
        import random
        import time

        def stamp():
            return time.time()

        def token():
            return os.urandom(8), random.random()

        def rng():
            return np.random.default_rng(), np.random.rand(3)
        """), _tl003_wall_clock),
    "tl003_import_forms": (sources_of("testing/mk.py", """\
        from time import time
        from random import randint
        """), _tl003_import_forms),
    "tl003_clean_twin": (sources_of("core/wait.py", """\
        import time

        def wait(deadline):
            t0 = time.monotonic()          # shapes timing, never recorded
            time.sleep(0.01)
            return time.monotonic() - t0

        def rng(seed):
            return np.random.default_rng(seed)
        """), _clean),
    "tl003_allowlist": (sources_of("launch/run.py", """\
        import time

        def banner():
            return time.time()
        """), _clean),
    "tl004_unlocked_inner_access": (sources_of("core/daemon.py", """\
        import threading

        class AsyncBackend:
            def __init__(self, inner):
                self.inner = inner
                self._apply_lock = threading.Lock()

            def peek(self):
                return self.inner.log
        """), _only("TL004", "epoch mid-application")),
    "tl004_clean_twin": (sources_of("core/daemon.py", """\
        import threading

        class AsyncBackend:
            def __init__(self, inner):
                self.inner = inner
                self._apply_lock = threading.Lock()

            def _observe(self, fn):
                with self._apply_lock:
                    return fn()

            def locked(self):
                with self._apply_lock:
                    return self.inner.log

            def via_lambda(self):
                return self._observe(lambda: self.inner.log)

            def via_local_def(self):
                def take():
                    return self.inner.snapshot()
                return self._observe(take)

        class SyncWrapper:
            # no _apply_lock: single-writer wrapper, rule does not bind
            def __init__(self, inner):
                self._inner = inner

            def read(self):
                return self._inner.read()
        """), _clean),
    "tl005_missing_method_and_signature_drift": (
        sources_of("core/cgroup.py", PROTO, **{"core/bad.py": """\
            class BadBackend:
                def __init__(self):
                    self.log = 0

                def read(self, path): ...
            """}), _tl005_missing),
    "tl005_unsanctioned_surface_and_missing_attr": (
        sources_of("core/cgroup.py", PROTO, **{"core/extra.py": """\
            class ExtraBackend:
                def __init__(self):
                    pass

                def read(self, path, file): ...
                def write(self, path, file, value): ...
                def frobnicate(self): ...
            """}), _tl005_surface),
    "tl005_clean_twin_and_getattr_passthrough": (
        sources_of("core/cgroup.py", PROTO, **{"core/good.py": """\
            class GoodBackend:
                def __init__(self):
                    self.log = 0

                def read(self, path, file): ...
                def write(self, path, file, value): ...
                def device_view(self): ...

            class WrapBackend:
                def __init__(self, inner):
                    self._inner = inner

                def __getattr__(self, name):
                    return getattr(self._inner, name)
            """}), _clean),
    "tl006_conditional_key": (sources_of("core/state.py", """\
        def new_state(flag):
            st = {"usage": 0}
            if flag:
                st["max"] = 1
            return st
        """), _only("TL006", "'max'")),
    "tl006_clean_twin": (sources_of("core/state.py", """\
        def new_state(flag):
            st = {"usage": 0}
            st["max"] = 1                  # unconditional: stable shape
            st["usage"] = 2 if flag else 0  # value change, not structure
            return st

        def restore(t, snap):
            st = dict(t.state)             # copy: shape is t's concern
            for key in ("usage", "peak"):
                if key in snap:
                    st[key] = snap[key]
            return st
        """), _clean),
    "suppression_with_justification": (sources_of("core/clock.py", """\
        import time

        def stamp():
            return time.time()  # tracelint: disable=TL003 -- fixture clock
        """), _clean),
    "own_line_suppression_covers_next_line": (sources_of("core/clock.py", """\
        import time

        def stamp():
            # tracelint: disable=TL003 -- fixture clock
            return time.time()
        """), _clean),
    "suppression_without_justification": (sources_of("core/clock.py", """\
        import time

        def stamp():
            return time.time()  # tracelint: disable=TL003
        """), _only("TL000", "without justification")),
    "suppression_in_decision_module": (sources_of("core/sched.py", """\
        import time

        def helper():
            return time.time()  # tracelint: disable=TL003 -- nope
        """), _in_decision_module),
    "suppression_in_enforcement_wrappers": (
        sources_of("kernels/enforcement.py", """\
        def glue(step):
            return int(step)  # tracelint: disable=TL001 -- ctypes glue
        """), _only("TL000", "decision-path module")),
    "unknown_rule_in_pragma": (sources_of("core/clock.py", """\
        x = 1  # tracelint: disable=TL999 -- no such rule
        """), _only("TL000", "TL999")),
    "file_level_suppression": (sources_of("core/clock.py", """\
        # tracelint: disable-file=TL003 -- whole-file fixture exemption
        import time

        def stamp():
            return time.time()

        def stamp2():
            return time.time()
        """), _clean),
    "syntax_error_is_a_finding": (
        {"core/broken.py": "def f(:\n"},
        _only("TL000", "syntax error")),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixture_agrees_with_reference(case):
    sources, check = SHARED[case]
    port = lint_sources(sources)
    ref = ref_lint.lint_sources(sources)
    assert keys(port) == keys(ref), (port, ref)
    check(port)


# --------------------------------------------------------------- TL001


def test_tl001_flags_python_branch_in_decision_module():
    findings = lint("core/progs.py", """\
        def charge_decision(prog, view, req):
            if view.usage > view.high:
                return 1
            return 0
        """)
    assert rules_fired(findings) == {"TL001"}
    assert "forks the one decision path" in findings[0].message
    assert "torch.where" in findings[0].message


def test_tl001_flags_host_reads_cast_numpy_assert_in_program_hooks():
    findings = lint("serving/myprog.py", """\
        class MyProg(PolicyProgram):
            def on_charge(self, view, req, params):
                assert req.pages > 0
                usage = view.usage.item()
                rows = view.params.cpu().numpy()
                ids = view.prog_id.tolist()
                cap = float(view.high)
                return np.minimum(usage, cap)
        """)
    msgs = [f.message for f in findings]
    assert all(f.rule == "TL001" for f in findings)
    for word in ("assert", ".item()", ".cpu()", ".numpy()", ".tolist()",
                 "float()", "np.minimum"):
        assert any(word in m for m in msgs), word


# One seeded violation and its clean twin per TL001 check, in torch idiom:
# (path, violation, clean twin, a word of the message).
TL001_PAIRS = {
    "if": ("core/progs.py", """\
        def gate_decision(prog, view, step):
            if view.frozen.any():
                return view.valid
            return ~view.valid
        """, """\
        def gate_decision(prog, view, step):
            return torch.where(view.frozen.any(), view.valid, ~view.valid)
        """, "'if'"),
    "while": ("core/controller.py", """\
        def _ancestor_chain(parent, idx):
            while idx >= 0:
                idx = parent[idx]
            return idx
        """, """\
        def _ancestor_chain(parent, idx):
            chain = [idx]
            for _ in range(3):
                chain.append(torch.where(chain[-1] >= 0, parent[chain[-1]],
                                         -1))
            return torch.stack(chain, dim=-1)
        """, "'while'"),
    "conditional_expression": ("core/controller.py", """\
        def _plain_slot_gate(state, slot_dom, step, progs):
            live = slot_dom >= 0
            return live if live.all() else ~live
        """, """\
        def _plain_slot_gate(state, slot_dom, step, progs):
            live = slot_dom >= 0
            return torch.where(live.all(), live, ~live)
        """, "conditional expression"),
    "assert": ("core/pressure.py", """\
        def saturating_count(counter, events):
            assert (events >= 0).all()
            return counter + events
        """, """\
        def saturating_count(counter, events):
            assert isinstance(counter, torch.Tensor)
            return counter + events
        """, "'assert'"),
    "item": ("core/sched.py", """\
        def schedule_weight(prog, view, req):
            return view.weight[0].item()
        """, """\
        def schedule_weight(prog, view, req):
            return view.weight[0]
        """, ".item()"),
    "tolist": ("core/controller.py", """\
        def uncharge_batch(state, dom, amt):
            return dict(state, usage=torch.tensor(state["usage"].tolist()))
        """, """\
        def uncharge_batch(state, dom, amt):
            return dict(state, usage=state["usage"].clone())
        """, ".tolist()"),
    "cpu": ("core/controller.py", """\
        def _plain_charge_batch(state, dom, amt, step, progs):
            return state["usage"].cpu()
        """, """\
        def _plain_charge_batch(state, dom, amt, step, progs):
            return state["usage"].clone()
        """, ".cpu()"),
    "numpy": ("kernels/enforcement.py", """\
        def fused_slot_gate(state, slot_dom, step, prog=None):
            return slot_dom.numpy() >= 0
        """, """\
        def fused_slot_gate(state, slot_dom, step, prog=None):
            return slot_dom >= 0
        """, ".numpy()"),
    "cast": ("kernels/enforcement.py", """\
        def fused_charge_batch(state, dom, amt, step, prog=None):
            return _route(dom)(state, dom, amt, int(step), prog)
        """, """\
        def fused_charge_batch(state, dom, amt, step, prog=None):
            return _route(dom)(state, dom, amt, step, prog)
        """, "int() cast"),
    "np_call": ("core/progs.py", """\
        def _decision_one(prog, view, req):
            return np.maximum(view.usage, 0)
        """, """\
        def _decision_one(prog, view, req):
            return torch.clamp(view.usage, min=0)
        """, "numpy call 'np.maximum'"),
    "synchronize_in_scope": ("core/sched.py", """\
        def schedule_decision(prog, state, dom, cost, step, budget):
            torch.cuda.synchronize()
            return state, dom >= 0
        """, """\
        def schedule_decision(prog, state, dom, cost, step, budget):
            return state, dom >= 0
        """, "host sync 'synchronize'"),
    "synchronize_module_wide": ("kernels/enforcement.py", """\
        def _launch_charge(state, dom, amt, step, progs):
            out = _call(state, dom, amt, step)
            torch.cuda.current_stream().synchronize()
            return out
        """, """\
        def _launch_charge(state, dom, amt, step, progs):
            return _call(state, dom, amt, step)
        """, "decision-path module"),
}


@pytest.mark.parametrize("check", sorted(TL001_PAIRS))
def test_tl001_seeded_violation_and_clean_twin(check):
    path, bad, good, word = TL001_PAIRS[check]
    findings = lint(path, bad)
    assert findings and rules_fired(findings) == {"TL001"}, findings
    assert any(word in f.message for f in findings), findings
    assert lint(path, good) == []


def test_tl001_host_sync_anywhere_in_decision_module():
    findings = lint("core/sched.py", """\
        def helper(x):
            torch.cuda.synchronize()
            return x
        """)
    assert "TL001" in rules_fired(findings)


def test_tl001_clean_twin():
    findings = lint("core/progs.py", """\
        def charge_decision(prog, view, req):
            grant = torch.where(view.usage > view.high, 0, 1)
            return grant

        class GraduatedThrottleProgram:
            def delay_ms(self, params, over_frac, priority=None):
                if priority is None:          # static dispatch
                    priority = params[0]
                return torch.clamp(priority, min=0.0)

        def host_helper(state):
            # not a decision entry point: a host read is fine here
            return state["usage"].cpu().tolist(), np.asarray(state["prog"])
        """)
    assert findings == []


def test_tl001_static_step_and_python_list_test_stay_clean():
    """The engine's step count passed through and offset, never cast or
    tested, reads no tensor.  A local bound only to list displays is
    tested by its length."""
    findings = lint("core/controller.py", """\
        def _plain_charge_batch(state, dom, amt, step, progs):
            granted, stalled = [], []
            for i in range(dom.shape[0]):
                granted.append(dom[i] >= 0)
                stalled.append(dom[i] < 0)
            empty = torch.zeros(0, dtype=torch.bool)
            return (torch.stack(granted) if granted else empty,
                    torch.stack(stalled) if len(stalled) > 0 else empty,
                    _launch(state, dom, amt, step + 1))
        """)
    assert findings == []
    # the same names bound to a tensor are not static
    findings = lint("core/controller.py", """\
        def _plain_charge_batch(state, dom, amt, step, progs):
            granted = dom >= 0
            return granted if granted else int(step)
        """)
    assert [f.message.split(" in ")[0] for f in findings] == [
        "python conditional expression", "int() cast"]
    # a parameter is never static, whatever its annotation says
    findings = lint("core/controller.py", """\
        def _plain_charge_batch(state, dom, amt, step: int, progs):
            return step + 1 if step >= 0 else int(step)
        """)
    assert [f.message.split(" in ")[0] for f in findings] == [
        "python conditional expression", "int() cast"]


def test_tl001_glue_below_the_roots_is_not_a_root():
    """Routing, checks and ctypes glue in the wrappers' module read
    metadata and Python values; they are not decision scopes."""
    assert lint("kernels/enforcement.py", """\
        def _charge_route(dom):
            if dom.is_cuda:
                return _launch
            return _plain if dom.dim() == 1 else _shards

        def charge_call(state, dom, amt, step, m):
            return lib.charge(dom.data_ptr(), m, int(step))
        """) == []


# --------------------------------------------------------------- TL002


def test_tl002_flags_scalar_closure():
    findings = lint("core/build.py", """\
        import torch

        class Builder:
            def make(self):
                scale = 2.0
                return torch.compile(lambda v: v * scale)
        """)
    assert rules_fired(findings) == {"TL002"}
    assert "'scale'" in findings[0].message


def test_tl002_flags_loop_variable_closure():
    findings = lint("core/build.py", """\
        import torch

        def build():
            fns = []
            for k in range(3):
                fns.append(torch.compile(lambda v: v + k))
            return fns
        """)
    assert rules_fired(findings) == {"TL002"}
    assert "loop variable" in findings[0].message


def test_tl002_clean_twin():
    findings = lint("core/build.py", """\
        import torch

        def module_fn(v):
            return v * 2.0

        compiled = torch.compile(module_fn)   # module level: no frame

        class Builder:
            def make(self):
                prog = self.prog          # object identity IS the code
                return torch.compile(lambda v: prog.on_charge(v))

            def make_arg(self):
                return torch.compile(lambda v, scale: v * scale)
        """)
    assert findings == []


# (violation, clean twin, a word of the message), each in core/build.py
TL002_PAIRS = {
    "jit_script_local_def": ("""\
        def build(x):
            cap = 4
            def step(v):
                return v.clamp(max=cap)
            return torch.jit.script(step)
        """, """\
        def build(x):
            def step(v, cap):
                return v.clamp(max=cap)
            return torch.jit.script(step)
        """, "'cap'"),
    "jit_trace": ("""\
        def build(x):
            gain = float(x)
            return torch.jit.trace(lambda v: v * gain, (x,))
        """, """\
        def build(x, table):
            return torch.jit.trace(lambda v: v * table[0], (x,))
        """, "'gain'"),
    "make_graphed_callables": ("""\
        def build(fns, sample):
            out = []
            for limit in (1, 2):
                out.append(torch.cuda.make_graphed_callables(
                    (lambda v: v.clamp(max=limit),), (sample,)))
            return out
        """, """\
        def build(fns, sample, limits):
            return torch.cuda.make_graphed_callables(
                (lambda v: v.clamp(max=limits[0]),), (sample,))
        """, "loop variable"),
    "compile_decorator": ("""\
        def build():
            step_ms = 10.0
            @torch.compile
            def delay(v):
                return v / step_ms
            return delay
        """, """\
        def build(prog):
            @torch.compile
            def delay(v, params):
                return v / params[0]
            return delay
        """, "'step_ms'"),
    "graph_capture_scalar": ("""\
        def capture(state, dom, amt):
            step = 7
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fused_charge_batch(state, dom, amt, step)
            return g, out
        """, """\
        def capture(state, dom, amt, step_t):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fused_charge_batch(state, dom, amt, step_t)
            return g, out
        """, "replays the value seen at capture"),
    "graph_capture_loop_variable": ("""\
        def capture_all(state, dom, amt):
            graphs = []
            for step in range(4):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fused_slot_gate(state, dom, step)
                graphs.append(g)
            return graphs
        """, """\
        def capture_all(state, dom, amt, steps):
            graphs = []
            for _ in range(4):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fused_slot_gate(state, dom, steps)
                graphs.append(g)
            return graphs
        """, "loop variable"),
}


@pytest.mark.parametrize("check", sorted(TL002_PAIRS))
def test_tl002_seeded_violation_and_clean_twin(check):
    bad, good, word = TL002_PAIRS[check]
    findings = lint("core/build.py", bad)
    assert findings and rules_fired(findings) == {"TL002"}, findings
    assert any(word in f.message for f in findings), findings
    assert lint("core/build.py", good) == []


def test_tl002_scope_is_core_and_decision_modules():
    src = """\
        def build():
            scale = 2.0
            return torch.compile(lambda v: v * scale)
        """
    assert rules_fired(lint("kernels/enforcement.py", src)) == {"TL002"}
    assert lint("serving/engine.py", src) == []


# --------------------------------------------------------------- TL003


def test_tl003_allowlist_takes_torch_draws():
    # launch/ measures: its draws and clocks are outside the replay path
    assert lint("launch/run.py", """\
        import time

        def banner():
            return time.time(), torch.randn(3)
        """) == []


# (violation, clean twin) through torch's process-global generator
TL003_TORCH_PAIRS = {
    "rand": ("torch.rand(3)", "torch.rand(3, generator=g)"),
    "randn": ("torch.randn(2, 3)", "torch.randn(2, 3, generator=g)"),
    "randint": ("torch.randint(0, 8, (4,))",
                "torch.randint(0, 8, (4,), generator=g)"),
    "randperm": ("torch.randperm(8)", "torch.randperm(8, generator=g)"),
    "normal": ("torch.normal(0.0, 1.0, (3,))",
               "torch.normal(0.0, 1.0, (3,), generator=g)"),
    "bernoulli": ("torch.bernoulli(p)", "torch.bernoulli(p, generator=g)"),
    "multinomial": ("torch.multinomial(p, 2)",
                    "torch.multinomial(p, 2, generator=g)"),
    "uniform_": ("x.uniform_(0, 1)", "x.uniform_(0, 1, generator=g)"),
    "normal_": ("x.normal_(0.0, 0.5)", "x.normal_(0.0, 0.5, generator=g)"),
    "manual_seed": ("torch.manual_seed(seed)",
                    "torch.Generator().manual_seed(seed)"),
    "seed": ("torch.seed()", "g.seed()"),
    "cuda_manual_seed": ("torch.cuda.manual_seed(seed)",
                         "torch.Generator('cuda').manual_seed(seed)"),
    "cuda_manual_seed_all": ("torch.cuda.manual_seed_all(seed)",
                             "g.manual_seed(seed)"),
}


@pytest.mark.parametrize("check", sorted(TL003_TORCH_PAIRS))
@pytest.mark.parametrize("where", ["core/gen.py", "traces/gen.py",
                                   "testing/gen.py"])
def test_tl003_torch_generator_violation_and_clean_twin(check, where):
    bad, good = TL003_TORCH_PAIRS[check]
    src = "def draw(x, p, g, seed):\n    return {}\n"
    findings = lint(where, src.format(bad))
    assert rules_fired(findings) == {"TL003"}, findings
    assert "process-global generator" in findings[0].message
    assert lint(where, src.format(good)) == []
    # the reference's rule knows no torch generator: nothing to agree on
    # there, but the port's TL003 is a superset on everything else
    assert ref_lint.lint_sources({where: src.format(bad)}) == []


# --------------------------------------------------------------- TL005


PORT_PROTO = """\
    from typing import Protocol

    class Backend(Protocol):
        log: int

        def read(self, path, file): ...
        def write(self, path, file, value): ...
        def snapshot(self): ...
    """

PORT_BACKEND = """\
    class TableBackend:
        def __init__(self):
            self.log = 0

        def read(self, path, file): ...
        def write(self, path, file, value): ...
        def snapshot(self): ...
    """

REF_BACKEND = """\
    class TableBackend:
        def __init__(self):
            self.log = 0

        def read(self, path, file): ...
        def write(self, path, file, value): ...
    """


def test_tl005_two_packages_each_against_its_own_protocol():
    """One scan of both packages: the reference linter holds every
    backend to the first protocol it meets (the reference's, which sorts
    first), the port's linter holds each to its own package's."""
    sources = {
        "src/repro/core/cgroup.py": textwrap.dedent(PROTO),
        "src/repro/core/table.py": textwrap.dedent(REF_BACKEND),
        "src/repro_torch/core/cgroup.py": textwrap.dedent(PORT_PROTO),
        "src/repro_torch/core/table.py": textwrap.dedent(PORT_BACKEND),
    }
    assert lint_sources(sources) == []
    ref = ref_lint.lint_sources(sources)
    assert [(f.rule, f.path) for f in ref] == [
        ("TL005", "src/repro_torch/core/table.py")]
    assert "snapshot is not in the Backend protocol" in ref[0].message
    # a port backend that drifts from the port's protocol is still caught
    drift = dict(sources, **{"src/repro_torch/core/table.py":
                             textwrap.dedent(REF_BACKEND)})
    found = lint_sources(drift)
    assert [(f.rule, f.path) for f in found] == [
        ("TL005", "src/repro_torch/core/table.py")]
    assert "missing Backend method 'snapshot()'" in found[0].message


def test_tl005_scan_of_src_holds_port_backends_to_port_protocol():
    """Over the real tree: the port's ``Backend`` sits in the port's
    package, and a scan of both packages reports nothing."""
    assert (PORT / "core" / "cgroup.py").read_text().count(
        "class Backend(Protocol):") == 1
    findings = lint_paths([str(REPO / "src")])
    assert findings == [], "\n".join(f.format() for f in findings)


# ----------------------------------------------------- baseline / report


def test_baseline_round_trip(tmp_path):
    findings = lint("core/rec.py", BAD_CORE)
    assert findings
    bpath = tmp_path / "baseline.json"
    write_baseline(str(bpath), findings)
    fps = load_baseline(str(bpath))
    kept, grandfathered = apply_baseline(findings, fps)
    assert kept == [] and grandfathered == len(findings)
    # a new finding is NOT covered
    more = lint("core/rec.py", BAD_CORE + "\n\ndef t2():\n"
                "    return time.time()\n")
    kept, _ = apply_baseline(more, fps)
    assert len(kept) == 1
    # the same file reads the same under the reference's loader
    assert ref_lint.load_baseline(str(bpath)) == fps


def test_json_report_schema():
    findings = lint("core/rec.py", BAD_CORE)
    payload = json.loads(render_json(findings, suppressed_by_baseline=2))
    assert payload["version"] == 1
    assert payload["total"] == len(findings) > 0
    assert payload["suppressed_by_baseline"] == 2
    assert payload["counts"] == {"TL003": len(findings)}
    for f in payload["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message"}
    assert "no findings" in render_text([])
    ref = json.loads(ref_lint.render_json(
        ref_lint.lint_sources({"core/rec.py": textwrap.dedent(BAD_CORE)}),
        suppressed_by_baseline=2))
    assert set(ref) == set(payload)
    assert [(f["rule"], f["path"], f["line"], f["col"])
            for f in ref["findings"]] == [
        (f["rule"], f["path"], f["line"], f["col"])
        for f in payload["findings"]]


# ---------------------------------------------------------- CLI + self-run


def test_cli_exit_codes_and_select(tmp_path, capsys):
    bad = tmp_path / "core" / "rec.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(BAD_CORE), encoding="utf-8")
    for main in (cli_main, ref_cli):
        assert main([str(tmp_path)]) == 1
        out = capsys.readouterr().out
        assert "TL003" in out and "time.time()" in out
        # selecting an unrelated rule: clean
        assert main([str(tmp_path), "--select", "TL004"]) == 0
        capsys.readouterr()
        assert main([str(tmp_path), "--select", "TL042"]) == 2
        assert main(["--list-rules"]) == 0
        assert main([str(tmp_path / "nope.txt")]) == 2


def test_cli_json_and_write_baseline(tmp_path, capsys):
    bad = tmp_path / "core" / "rec.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(BAD_CORE), encoding="utf-8")
    assert cli_main([str(tmp_path), "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["total"] == 1
    assert ref_cli([str(tmp_path), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["findings"] == \
        payload["findings"]
    bpath = tmp_path / "baseline.json"
    assert cli_main([str(tmp_path), "--write-baseline", str(bpath)]) == 0
    capsys.readouterr()
    assert cli_main([str(tmp_path), "--baseline", str(bpath)]) == 0
    assert "grandfathered" in capsys.readouterr().out
    assert ref_cli([str(tmp_path), "--baseline", str(bpath)]) == 0
    capsys.readouterr()
    assert cli_main([str(tmp_path), "--baseline",
                     str(tmp_path / "missing.json")]) == 2


def test_every_rule_has_id_name_description():
    by_id = rules_by_id()
    ref = ref_lint.rules_by_id()
    assert set(by_id) == set(ref) == {"TL001", "TL002", "TL003", "TL004",
                                      "TL005", "TL006"}
    for rid, r in by_id.items():
        assert r.name == ref[rid].name and r.description


VIOLATIONS = {
    "TL001": ("core/controller.py", TL001_PAIRS["cpu"][1]),
    "TL002": ("core/build.py", TL002_PAIRS["graph_capture_scalar"][0]),
    "TL003": ("traces/gen.py", "def f():\n    return torch.randn(3)\n"),
}


@pytest.mark.parametrize("rule", sorted(VIOLATIONS))
def test_cli_fails_each_torch_idiom_violation(rule, tmp_path, capsys):
    """The acceptance command over a torch-idiom violation: exit 1 with
    the rule; the JAX linter passes it."""
    rel, src = VIOLATIONS[rule]
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(textwrap.dedent(src), encoding="utf-8")
    assert cli_main([str(tmp_path), "--baseline", BASELINE]) == 1
    assert f" {rule} " in capsys.readouterr().out
    assert ref_cli([str(tmp_path), "--baseline", BASELINE]) == 0


# The self-run: the port lints clean under its own linter, as the
# reference does under its.


def test_selfrun_core_is_finding_free():
    findings = lint_paths([str(PORT / "core")])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_selfrun_port_and_chip_smoke_exit_clean():
    rc = cli_main([str(PORT), str(REPO / "chip_smoke.py"),
                   "--baseline", BASELINE])
    assert rc == 0


def test_selfrun_module_entry_point_from_the_root():
    """``python -m repro_torch.analysis.lint`` with its default paths,
    from the root of the checkout, as the README gives it."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--baseline",
         "tracelint-baseline.json", "--json"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["total"] == 0


def test_selfrun_decision_modules_have_zero_suppressions():
    for mod in DECISION_MODULES:
        text = (PORT / mod).read_text()
        assert "tracelint:" not in text, mod


def test_selfrun_jax_linter_over_src_still_exits_clean():
    assert ref_cli([str(REPO / "src"), "--baseline", BASELINE]) == 0


def test_checked_in_baseline_is_empty():
    assert load_baseline(BASELINE) == frozenset()
    assert ref_lint.load_baseline(BASELINE) == frozenset()
