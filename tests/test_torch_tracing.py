"""The port's spans, step clock and admission records
(``repro_torch.tracing``) on the CPU engine at the reduced f32
``llama3.2-3b`` of ``tests/test_torch_engine.py``: one row a step whose
phases tile it, one admission record a submitted session, rings that
wrap in place, the engine's phases as host ranges of the profiler (never
user annotations), and no range at all without a profiler."""
import dataclasses

import pytest
torch = pytest.importorskip("torch")

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.core import domains as D
from repro_torch.core.events import Ev
from repro_torch.models import model as M
from repro_torch.serving import session as S
from repro_torch.serving.engine import Engine, EngineConfig

COMMON = dict(max_slots=4, s_max=384, page_tokens=16)
# a pool the sessions overrun: the daemon freezes LOW sessions from step
# 17 and thaws one at step 19
PRESSED = dict(COMMON, pool_pages=4, mode="inkernel", use_freeze=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype="float32")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def sessions(n: int, prompt: int = 24, gen: int = 8, append: int = 32):
    return [S.Session(sid=f"s{i}", tenant="t",
                      priority=D.HIGH if i == 0 else D.LOW,
                      prompt=list(range(2, 2 + prompt)),
                      phases=[S.Phase(gen, append, "test"), S.Phase(gen)])
            for i in range(n)]


def engine(model, n_sessions: int, **kw) -> Engine:
    cfg, params = model
    eng = Engine(cfg, params, ecfg=EngineConfig(**{
        "pool_pages": 64, **COMMON, **kw}), seed=0, device="cpu")
    for s in sessions(n_sessions):
        eng.submit(s)
    return eng


def rows(table: dict, eng: Engine) -> dict:
    mine = table["engine"] == eng.trace_id
    return {k: v[mine] for k, v in table.items()}


@pytest.mark.parametrize("mode", ["inkernel", "userspace"])
def test_one_row_a_step_its_phases_tiling_it(model, mode):
    eng = engine(model, 3, mode=mode)
    eng.run(40)
    st = rows(tracing.steps(), eng)
    assert st["step"].tolist() == list(range(eng.step_no))
    span = st["end_ns"] - st["start_ns"]
    phases = sum(st[p] for p in tracing.PHASES)
    assert (span > 0).all() and (st["start_ns"][1:] >= st["end_ns"][:-1]).all()
    assert (abs(phases - span) <= 0.01 * span).all()
    assert all((st[p] >= 0).all() for p in tracing.PHASES)
    assert (st["issue"] > 0).all()


def test_admission_records_equal_the_admitted_sessions(model):
    eng = engine(model, 6)          # 4 slots: 2 sessions wait
    eng.step()
    se = rows(tracing.sessions(), eng)
    assert se["priority"].tolist() == [D.HIGH] + [D.LOW] * 5
    admitted = se["admit_ns"] >= 0
    assert admitted.tolist() == [True] * 4 + [False] * 2
    assert (se["admit_ns"][~admitted] == -1).all()
    eng.run(2000)
    assert eng.done()
    se = rows(tracing.sessions(), eng)
    n_admits = sum(e.kind is Ev.ADMIT for e in eng.log.events)
    assert n_admits == len(se["engine"]) == 6
    assert (se["admit_ns"] >= se["submit_ns"]).all()
    # the waiting two were admitted when slots freed, steps later
    st = rows(tracing.steps(), eng)
    assert (se["admit_ns"][4:] > st["end_ns"][0]).all()


def test_rings_wrap_at_capacity_without_growing(model, monkeypatch):
    monkeypatch.setattr(tracing, "_steps",
                        tracing._Ring(tracing.STEP_COLUMNS, 8))
    monkeypatch.setattr(tracing, "_sessions",
                        tracing._Ring(tracing.SESSION_COLUMNS, 2))
    eng = engine(model, 3)
    eng.run(20)
    st = tracing.steps()
    assert st["step"].tolist() == list(range(12, 20))
    assert tracing._steps._rows.shape == (8, len(tracing.STEP_COLUMNS))
    se = tracing.sessions()
    # the first session's row was overwritten: its admission writes
    # nothing into the rows that took its place
    assert len(se["engine"]) == 2 and (se["admit_ns"] >= se["submit_ns"]).all()
    tracing.reset()
    assert len(tracing.steps()["step"]) == 0
    assert len(tracing.sessions()["engine"]) == 0
    eng.step()
    assert tracing.steps()["step"].tolist() == [20]


def test_phases_are_host_ranges_of_the_profiler(model):
    from torch.profiler import ProfilerActivity, profile
    pressed = engine(model, 3, **PRESSED)
    pressed.run(15)
    userspace = engine(model, 3, mode="userspace")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pressed.run(6)
        userspace.run(2)
    assert pressed.metrics.n_freezes and pressed.metrics.n_thaws
    names = {}
    for e in prof.events():
        names.setdefault(e.name, set()).add(e.is_user_annotation)
    want = {f"engine.{p}" for p in tracing.PHASES} | {
        "engine.charge", "engine.sample", "engine.merge_save",
        "engine.merge_restore", "engine.snapshot", "engine.freeze",
        "engine.thaw", "engine.admit", "model.layer.attn"}
    assert want <= set(names), want - set(names)
    assert all(names[n] == {False} for n in want)


def test_no_profiler_no_range(model, monkeypatch):
    opened = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    assert tracing.span("engine.issue") is tracing._OFF
    engine(model, 3, mode="userspace").run(20)
    assert opened == []
