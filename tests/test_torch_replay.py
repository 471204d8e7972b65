"""The paper's trace-replay drivers on the port against their sources:
Fig 8 (``benchmarks/fig8_replay.py``), Table 2's baselines
(``examples/replay_traces.py``), semantic OOM escalation
(``benchmarks/escalation_waste.py``, n 8, seed 1) and pressure-adaptive
soft limits (``benchmarks/adaptive_pressure.py``).  Each driver's
returned dict and printed lines are identical (floats equal, not close),
and every replay it runs has the same event log by time, kind and path.
"""
import contextlib
import importlib.util
import io
import math
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def load(path: str):
    spec = importlib.util.spec_from_file_location(
        "ref_" + Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recorded(monkeypatch, mod) -> list:
    """Record the result of every replay ``mod`` runs (through its
    ``replay`` function or its ``Replay`` class)."""
    runs = []
    if hasattr(mod, "replay"):
        inner = mod.replay

        def rec(*a, **kw):
            runs.append(inner(*a, **kw))
            return runs[-1]

        monkeypatch.setattr(mod, "replay", rec)
    if hasattr(mod, "Replay"):
        class Rec(mod.Replay):
            def run(self):
                runs.append(super().run())
                return runs[-1]

        monkeypatch.setattr(mod, "Replay", Rec)
    return runs


def plain(x):
    """NaN-safe, type-agnostic form of a driver's dict for ``==``."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if hasattr(x, "render"):              # a typed PressureEvent
        return (type(x).__name__, x.render(), x.t_ms)
    return x


def call(fn, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(**kw)
    return result, out.getvalue()


DRIVERS = {
    "fig8": ("benchmarks/fig8_replay.py", "fig8_replay", "run", {}),
    "table2": ("examples/replay_traces.py", "replay_traces", "main", {}),
    "escalation_waste": ("benchmarks/escalation_waste.py",
                         "escalation_waste", "run", dict(n=8, seed=1)),
    "adaptive_pressure": ("benchmarks/adaptive_pressure.py",
                          "adaptive_pressure", "run", dict(n=8, seed=1)),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_identical(monkeypatch, name):
    src, port_name, fn, kw = DRIVERS[name]
    ref = load(src)
    port = importlib.import_module(f"repro_torch.traces.{port_name}")
    ref_runs, port_runs = recorded(monkeypatch, ref), recorded(monkeypatch,
                                                                port)
    want, want_out = call(getattr(ref, fn), **kw)
    got, got_out = call(getattr(port, fn), **kw)
    assert got_out == want_out
    if want is not None:
        assert plain(got) == plain(want)
    assert len(port_runs) == len(ref_runs) > 0
    for g, w in zip(port_runs, ref_runs):
        assert plain(g.summary()) == plain(w.summary())
        assert g.escalation == w.escalation
        assert [(e.t_ms, e.kind.value, e.domain) for e in g.log.events] \
            == [(e.t_ms, e.kind.value, e.domain) for e in w.log.events]
    if name == "table2":
        assert [r["policy"] for r in got] == [r.policy for r in ref_runs]

