"""The port's serving engine against the JAX engine: the sessions of
``tests/test_engine.py`` on the reduced f32 ``llama3.2-3b`` with the
JAX weights carried over, in ``inkernel`` mode (with per-session
``memory.high``), in ``userspace`` mode, in ``nolimit`` mode, and in
``inkernel`` mode under the weighted step scheduler (``sched_slots``);
sessions derived from generated traces through ``session_from_trace``;
and the control planes beside the device table: the async lifecycle
daemon (with a poisoned daemon rebuilt mid-run) and the sharded table;
and the other decoder families on the same sessions: reduced Jamba
(inkernel and userspace), xLSTM and llama4-maverick, with their greedy
token streams, a denied slot's recurrent state and a frozen-then-thawed
slot's state held bit for bit.  ``Engine.report()`` follows session
phases, not token values, and must be field-identical.  The JAX reports
are computed once per module."""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_leaves

from repro.core import domains as JD
from repro.core import sched as JSched
from repro.serving import session as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.traces import generator as JG
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import domains as TD
from repro_torch.core import sched as TSched
from repro_torch.core.cgroup import DeviceTableBackend
from repro_torch.core.daemon import AsyncDaemonBackend
from repro_torch.core.events import Ev as TEv
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import model as TM
from repro_torch.serving import session as TS
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.traces import generator as TG

COMMON = dict(max_slots=4, s_max=384, pool_pages=40, page_tokens=16)
MODES = {
    "inkernel": dict(mode="inkernel", use_freeze=True,
                     session_high={"lo1": 12, "lo2": 12}),
    "userspace": dict(mode="userspace", use_freeze=False,
                      use_tool_domains=False, use_intent=False,
                      session_high={"lo1": 12, "lo2": 12}),
    "inkernel_sched": dict(mode="inkernel", use_freeze=True, sched_slots=2),
    "nolimit": dict(mode="nolimit", use_freeze=False, use_tool_domains=False,
                    use_intent=False),
}
# modes whose engine runs the weighted-fair program (weighted slots only
# exist under it: the stock program bypasses the scheduler)
WEIGHTED = {"inkernel_sched"}


def sessions(S, D):
    """The three sessions of ``tests/test_engine.py``, in either package."""
    return [
        S.Session(sid="hi", tenant="t", priority=D.HIGH,
                  prompt=list(range(2, 34)),
                  phases=[S.Phase(8, 96, "test"), S.Phase(8, 64, "git"),
                          S.Phase(12, 0)]),
        S.Session(sid="lo1", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
        S.Session(sid="lo2", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
    ]


def trace_sessions(S, D, G):
    """Four sessions mapped from generated traces (1 HIGH, 3 LOW), in
    either package: tool-call bursts become phases."""
    out = []
    for i in range(4):
        trace = G.generate_task(f"agent-{i}", "glm" if i % 2 else "haiku",
                                seed=100 + i, scale=0.6)
        out.append(S.session_from_trace(
            f"s{i}", "t", trace, priority=D.HIGH if i == 0 else D.LOW,
            tokens_per_mb=0.25, gen_per_call=8, max_phases=4))
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU engine runs many small matmuls, faster on one
    thread than on many, and far faster where test workers share the
    cores; the reports follow session phases, not token values."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a pool the trace sessions overrun: throttles, freezes and thaws act
TRACE_ENGINE = dict(max_slots=4, s_max=384, pool_pages=16, page_tokens=16,
                    mode="inkernel", use_freeze=True,
                    session_high={"s1": 4, "s2": 4, "s3": 4})


@pytest.fixture(scope="module")
def jax_reports(tiny_llama):
    cfg, params = tiny_llama
    out = {}
    for name, kw in MODES.items():
        eng = JEngine(cfg, params, ecfg=JEngineConfig(**COMMON, **kw), seed=0)
        if name in WEIGHTED:
            eng.attach_program(JSched.WeightedFairProgram())
        for s in sessions(JS, JD):
            eng.submit(s)
        eng.run(6000)
        out[name] = eng.report()
    eng = JEngine(cfg, params, ecfg=JEngineConfig(**TRACE_ENGINE), seed=0)
    for s in trace_sessions(JS, JD, JG):
        eng.submit(s)
    eng.run(6000)
    out["trace_sessions"] = eng.report()
    return out


@pytest.fixture(scope="module")
def torch_model(tiny_llama):
    _, params = tiny_llama
    tcfg = dataclasses.replace(t_reduced(t_get_config("llama3.2-3b")),
                               dtype="float32")
    return tcfg, TM.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_report_field_identical(jax_reports, torch_model, mode):
    tcfg, tparams = torch_model
    eng = TEngine(tcfg, tparams, ecfg=TEngineConfig(**COMMON, **MODES[mode]),
                  seed=0, device="cpu")
    if mode in WEIGHTED:
        eng.attach_program(TSched.WeightedFairProgram())
    for s in sessions(TS, TD):
        eng.submit(s)
    reset_launch_counts()
    eng.run(6000)
    assert eng.report() == jax_reports[mode]
    # the CPU run takes the plain versions: no kernel launched
    assert set(launch_counts().values()) == {0}


def test_trace_sessions_report_field_identical(jax_reports, torch_model):
    """``session_from_trace`` sessions through the port's engine: the
    report equals the JAX engine's on the same traces."""
    tcfg, tparams = torch_model
    eng = TEngine(tcfg, tparams, ecfg=TEngineConfig(**TRACE_ENGINE), seed=0,
                  device="cpu")
    for s in trace_sessions(TS, TD, TG):
        eng.submit(s)
    eng.run(6000)
    report = eng.report()
    assert report == jax_reports["trace_sessions"]
    assert report["completed"] == 4 and report["throttle_triggers"] > 0


def test_entry_points_default_to_the_card():
    """Without ``device=`` the entry points ask for CUDA; where torch sees
    no card they raise instead of quietly running on the CPU."""
    tcfg = t_reduced(t_get_config("llama3.2-3b"))
    if torch.cuda.is_available():
        assert DeviceTableBackend(16).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceTableBackend(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tcfg, {}, ecfg=TEngineConfig(**COMMON))


@pytest.mark.parametrize("make", ["new_state", "DeviceDomainTable",
                                  "SlotCaches"])
def test_constructors_default_to_the_card(make):
    """The control state, the device table and the slot caches are built
    on the card unless the caller passes a device: without one, where
    torch sees no card, each raises instead of running on the CPU."""
    from repro_torch.core import controller as TC
    from repro_torch.serving.kvcache import SlotCaches
    tcfg = t_reduced(t_get_config("llama3.2-3b"))
    build, tensor = {
        "new_state": (lambda: TC.new_state(16, 4), lambda s: s["usage"]),
        "DeviceDomainTable": (lambda: TC.DeviceDomainTable(16, 4),
                              lambda t: t.state["usage"]),
        "SlotCaches": (lambda: SlotCaches(tcfg, 2, 32),
                       lambda c: tree_leaves(c.state)[0]),
    }[make]
    if torch.cuda.is_available():
        assert tensor(build()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


# ---------------------------------------------- async daemon, sharded table


INKERNEL = dict(COMMON, **MODES["inkernel"])
POISON_AFTER = 40          # steps before the daemon is poisoned


def _run_async(E, Cfg, cfg, params, S, D, poison: bool, **dev):
    """The inkernel sessions with ``backend="async"``; with ``poison``
    the daemon is poisoned between step 40 and 41, as the JAX engine
    test does (``tests/test_engine.py``)."""
    eng = E(cfg, params, ecfg=Cfg(**INKERNEL, backend="async"), seed=0,
            **dev)
    for s in sessions(S, D):
        eng.submit(s)
    if poison:
        for _ in range(POISON_AFTER):
            eng.step()
        eng.cg.backend._wedged = True        # poison between steps
    eng.run(6000)
    return eng


def _jax_async(tiny_llama, poison: bool) -> tuple:
    cfg, params = tiny_llama
    eng = _run_async(JEngine, JEngineConfig, cfg, params, JS, JD, poison)
    out = (eng.report(), eng.metrics.n_rebuilds, eng.cg.usage("/"))
    eng.close()
    return out


def test_async_report_field_identical(tiny_llama, torch_model):
    """``backend="async"``: lifecycle ops in daemon epochs, the report
    equal to the port's device-table run's and to the JAX async run's."""
    tcfg, tparams = torch_model
    eng = _run_async(TEngine, TEngineConfig, tcfg, tparams, TS, TD, False,
                     device="cpu")
    report = eng.report()
    assert report == _run_inkernel(TEngine, TEngineConfig, tcfg, tparams,
                                   sessions(TS, TD)).report()
    assert report == _jax_async(tiny_llama, False)[0]
    assert isinstance(eng.cg.backend, AsyncDaemonBackend)
    assert eng.cg.backend.epoch > 0       # lifecycle really ran in epochs
    assert eng.cg.usage("/") == 0
    eng.close()
    assert not eng.cg.backend._thread.is_alive()


def test_poisoned_daemon_rebuild_field_identical(tiny_llama, torch_model):
    """A daemon poisoned after step 40: the next step rebuilds the
    backend from the last step-boundary snapshot and the run completes,
    with the JAX engine's report, one rebuild, full survival and clean
    accounting."""
    tcfg, tparams = torch_model
    eng = _run_async(TEngine, TEngineConfig, tcfg, tparams, TS, TD, True,
                     device="cpu")
    report = eng.report()
    assert (report, eng.metrics.n_rebuilds, eng.cg.usage("/")) == \
        _jax_async(tiny_llama, True)
    assert eng.metrics.n_rebuilds == 1
    assert report["survival"] == 1.0 and report["overshoot_pages"] == 0
    assert eng.log.count(TEv.REBUILD) == 1
    for s in eng.sessions.values():
        assert s.length == len(s.prompt) + sum(
            p.gen_tokens + p.append_tokens for p in s.phases), s.sid
    eng.close()


def _run_inkernel(E, Cfg, cfg, params, sess, **kw):
    """The inkernel engine on ``sess`` (the device table unless ``kw``
    names another backend)."""
    eng = E(cfg, params, ecfg=Cfg(**INKERNEL, **kw), seed=0,
            **({"device": "cpu"} if E is TEngine else {}))
    for s in sess:
        eng.submit(s)
    eng.run(6000)
    return eng


def test_sharded_one_shard_report_field_identical(tiny_llama, torch_model):
    """``backend="sharded"`` at one shard (the JAX package's shard count
    on one device): the JAX sharded engine's report."""
    cfg, params = tiny_llama
    tcfg, tparams = torch_model
    want = _run_inkernel(JEngine, JEngineConfig, cfg, params,
                         sessions(JS, JD), backend="sharded").report()
    eng = _run_inkernel(TEngine, TEngineConfig, tcfg, tparams,
                        sessions(TS, TD), backend="sharded")
    assert eng.report() == want
    assert eng.cg.backend.placement() == {"/t": 0}
    assert eng.cg.usage("/") == 0


def two_tenant_sessions():
    """The parity sessions with the LOW ones in a second tenant, so two
    shards both serve."""
    out = sessions(TS, TD)
    for s in out[1:]:
        s.tenant = "u"
    return out


def test_two_shards_hold_the_guarantees(torch_model):
    """Two device groups, one tenant each: full survival, no pool
    overshoot, throttles acting, clean accounting."""
    tcfg, tparams = torch_model
    eng = _run_inkernel(TEngine, TEngineConfig, tcfg, tparams,
                        two_tenant_sessions(), backend="sharded", n_shards=2)
    r = eng.report()
    assert r["survival"] == 1.0 and r["overshoot_pages"] == 0
    assert r["throttle_triggers"] > 0
    assert eng.cg.usage("/") == 0
    assert eng.cg.backend.placement() == {"/t": 0, "/u": 1}
    assert eng.pool_capacity == 2 * COMMON["pool_pages"]


# ------------------------------------------- the other decoder families

# (arch, mode) runs held against the JAX engine: the recurrent families
# (Jamba's Mamba-2 layers, xLSTM's mLSTM/sLSTM) and the MoE GQA maverick
FAMILY_RUNS = [("jamba-v0.1-52b", "inkernel"), ("jamba-v0.1-52b", "userspace"),
               ("xlstm-350m", "inkernel"),
               ("llama4-maverick-400b-a17b", "inkernel")]
RECURRENT_ARCHS = ["jamba-v0.1-52b", "xlstm-350m"]


@pytest.fixture(scope="module")
def family_models():
    """Reduced f32 models of each family, the JAX weights (widened as the
    hybrid and families tests widen them) carried over to the port."""
    from repro.configs import get_config, reduced
    from repro.models import model as JM
    from repro.models.schema import init_params
    from test_torch_families import lively as lively_xlstm
    from test_torch_hybrid import lively as lively_mamba

    out = {}
    for arch in {a for a, _ in FAMILY_RUNS}:
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
        tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                                   dtype="float32")
        raw = jax.tree.map(np.asarray, init_params(
            JM.param_schema(cfg), jax.random.PRNGKey(0), cfg.dtype))
        raw = (lively_mamba if "mamba" in cfg.layer_kinds()
               else lively_xlstm)(raw, cfg)
        out[arch] = (cfg, jax.tree.map(jax.numpy.asarray, raw), tcfg,
                     TM.params_from_jax(raw, tcfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def family_runs(family_models):
    """Each (arch, mode) run on both engines, once: (report, token
    streams) of the JAX engine and of the port's."""
    out = {}
    for arch, mode in FAMILY_RUNS:
        cfg, params, tcfg, tparams = family_models[arch]
        runs = []
        for E, Cfg, model, S, D, dev in (
                (JEngine, JEngineConfig, (cfg, params), JS, JD, {}),
                (TEngine, TEngineConfig, (tcfg, tparams), TS, TD,
                 {"device": "cpu"})):
            eng = E(*model, ecfg=Cfg(**COMMON, **MODES[mode]), seed=0, **dev)
            sess = sessions(S, D)
            for s in sess:
                eng.submit(s)
            eng.run(6000)
            runs.append((eng.report(), [s.out_tokens for s in sess]))
        out[arch, mode] = runs
    return out


@pytest.mark.parametrize("arch,mode", FAMILY_RUNS,
                         ids=[f"{a}-{m}" for a, m in FAMILY_RUNS])
def test_family_report_field_identical(family_runs, arch, mode):
    (jreport, _), (treport, _) = family_runs[arch, mode]
    assert treport == jreport
    assert treport["completed"] == 3
    if mode == "inkernel":       # freeze/thaw carried the states
        assert treport["freezes"] >= 1 and treport["thaws"] >= 1


@pytest.mark.parametrize("arch", sorted({a for a, _ in FAMILY_RUNS}))
def test_family_greedy_streams_equal(family_runs, arch):
    """At temperature 0 every session samples the JAX engine's tokens."""
    (_, jstreams), (_, tstreams) = family_runs[arch, "inkernel"]
    assert tstreams == jstreams
    assert all(len(s) > 0 for s in tstreams)


def _slot_leaves(state, slot):
    return [t[:, slot].clone() for pos in state for t in pos.values()]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_denied_slot_keeps_its_state_bit_for_bit(family_models, arch):
    """A step whose gate denies slot 0: slot 0's whole state (recurrent
    leaves and cache rows) is bit-identical after it, while the granted
    slot's recurrent state moved."""
    _, _, tcfg, tparams = family_models[arch]
    eng = TEngine(tcfg, tparams, ecfg=TEngineConfig(**COMMON), seed=0,
                  device="cpu")
    for s in sessions(TS, TD)[:2]:
        eng.submit(s)
    for _ in range(6):
        eng.step()
    state = eng.caches.state
    dom = torch.tensor([eng.sessions[sid].dom_idx for sid in
                        eng.slot_session[:2]] + [-1, -1], dtype=torch.int32)
    tokens = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
    lengths = torch.tensor([eng.sessions[sid].length for sid in
                            eng.slot_session[:2]] + [0, 0], dtype=torch.int32)
    before = [_slot_leaves(state, b) for b in (0, 1)]
    nxt, _, granted, _ = eng._device_step(
        tokens, lengths, dom, torch.zeros(4, dtype=torch.int32),
        torch.tensor([False, True, False, False]), inkernel=False)
    assert granted.tolist() == [False, True, False, False]
    assert int(nxt[0]) == 3
    for a, b in zip(before[0], _slot_leaves(state, 0)):
        assert torch.equal(a, b)
    kinds = [kind for kind, pos in zip(tcfg.layer_kinds(), state)
             for _ in pos]
    same = [torch.equal(a, b) for a, b, kind in zip(
        before[1], _slot_leaves(state, 1), kinds) if kind != "attn"]
    assert same and not any(same)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_freeze_thaw_gives_the_state_back_bit_for_bit(family_models, arch):
    """A slot's recurrent states and caches, filled from a seeded draw,
    come back bit-identical in the slot a thaw picks; the frozen slot is
    zeroed for reuse."""
    from repro_torch.serving.kvcache import SlotCaches

    _, _, tcfg, _ = family_models[arch]
    caches = SlotCaches(tcfg, 3, 32, "cpu")
    g = torch.Generator().manual_seed(0)
    for pos in caches.state:
        for t in pos.values():
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    assert [caches.alloc_slot() for _ in range(3)] == [0, 1, 2]
    want = _slot_leaves(caches.state, 1)
    caches.free_slot(0)                  # the thaw takes slot 0
    caches.freeze_slot("s", 1, pages=3)
    assert all(not t.any() for t in _slot_leaves(caches.state, 1))
    slot, _ = caches.thaw_slot("s")
    assert slot == 0
    got = _slot_leaves(caches.state, slot)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
