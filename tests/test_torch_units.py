"""The control-plane helpers this slice restores or ports, against the
JAX package's, on the cases of ``tests/test_escalation.py``,
``tests/test_pressure.py`` and ``tests/test_data_intent.py`` that touch
them: ``parse_psi``, ``parse_hint``, ``feedback_from_oom``,
``AdaptiveAgentModel``, the escalation policy, ``Escalator`` and
``WasteLedger`` over the port's host tree, and ``AdaptiveController``.
Each case runs through both packages and must give the same values."""
import dataclasses

import pytest

from repro.core import adaptive as JA
from repro.core import cgroup as JC
from repro.core import domains as JD
from repro.core import escalation as JE
from repro.core import events as JEv
from repro.core import intent as JI
from repro.core import pressure as JP
from repro_torch.core import adaptive as TA
from repro_torch.core import cgroup as TC
from repro_torch.core import domains as TD
from repro_torch.core import escalation as TE
from repro_torch.core import events as TEv
from repro_torch.core import intent as TI
from repro_torch.core import pressure as TP

PKGS = {"jax": (JA, JC, JD, JE, JEv, JI, JP),
        "torch": (TA, TC, TD, TE, TEv, TI, TP)}


def both(fn):
    """``fn`` run on each package's modules; the two results."""
    return fn(*PKGS["torch"]), fn(*PKGS["jax"])


def fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: fields(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [fields(x) for x in obj]
    return getattr(obj, "name", obj) if hasattr(obj, "value") else obj


def test_parse_psi_and_hint():
    lines = ["some avg10=12.34 avg60=5.68 total=42",
             "some avg10=0.00 avg60=100.00 total=0",
             TP.format_psi(0.1234, 0.056789, 42)]
    assert [TP.parse_psi(s) for s in lines] == [JP.parse_psi(s)
                                                for s in lines]
    for s in ("memory:high", "memory:low", "memory:medium", "bogus", "",
              None):
        t, j = TI.parse_hint(s), JI.parse_hint(s)
        assert (t and t.name) == (j and j.name)


def test_feedback_from_oom_and_agent_model():
    def run(A, C, D, E, Ev, I, P):
        e = Ev.OomEvent(path="/s/tool", session="/s", peak_pages=80,
                        limit_pages=100, attempt=1, residual_pages=80)
        fb = I.feedback_from_oom(e)
        agent = I.AdaptiveAgentModel()
        adj = agent.on_feedback("python", I.make_feedback("x", "oom", 700,
                                                          512))
        adj2 = agent.on_feedback("git", I.make_feedback("y", "frozen", 1, 2))
        return (e.render(), fields(fb), fields(adj), fields(adj2),
                fields(agent.hint_for("python", I.Hint.MEDIUM)),
                fields(agent.hint_for("git", I.Hint.LOW)),
                fields(agent.learned))
    t, j = both(run)
    assert t == j
    assert t[1]["reason"] == "oom_kill" and t[2]["scale"] == 0.5


def test_negotiation_and_backoff():
    def run(A, C, D, E, Ev, I, P):
        def ev(peak=80, limit=100, attempt=1):
            return Ev.OomEvent(path="/s/tool", session="/s",
                               peak_pages=peak, limit_pages=limit,
                               attempt=attempt, residual_pages=peak)
        pol = E.EscalationPolicy(growth=2.0, headroom=1.25)
        out = [pol.negotiate(ev(peak=40), 10_000),
               pol.negotiate(ev(peak=400), 10_000),
               E.EscalationPolicy().negotiate(ev(), 150),
               E.EscalationPolicy(max_attempts=3).negotiate(ev(attempt=3),
                                                            10_000),
               E.EscalationPolicy().negotiate(ev(), 100)]
        b = E.EscalationPolicy(base_backoff_ms=20.0, backoff_factor=2.0,
                               jitter_frac=0.25)
        return fields(out), [b.backoff_ms(k, a) for k in ("/s/tool", "/s/x")
                             for a in (1, 2, 3)]
    t, j = both(run)
    assert t == j
    assert [n and n["grant_pages"] for n in t[0]] == [200, 500, 150, None,
                                                      None]


def test_escalator_and_ledger_over_the_host_tree():
    def run(A, C, D, E, Ev, I, P):
        cg = C.AgentCgroup(C.HostTreeBackend(1000))
        cg.mkdir("/s", C.DomainSpec(max=400))
        lease = cg.intent.declare("tool_1", I.Hint.LOW, parent="/s",
                                  high=50, max=50)
        cg.try_charge(lease.path, 40)
        freed = [cg.kill(lease.path)]
        esc = E.Escalator(cg, E.EscalationPolicy(growth=2.0))
        negs = []
        for pages in (90, 190):
            lease, neg = esc.escalate(lease)
            negs.append(neg)
            cg.try_charge(lease.path, pages)
            freed.append(cg.kill(lease.path))
        lease, neg = esc.escalate(lease)
        negs.append(neg)
        ooms = cg.intent.oom_events("/s", clear=True)
        # exhaustion is loud and cleans up
        cg.mkdir("/t")
        dead = cg.intent.declare("tool_2", None, parent="/t", high=50,
                                 max=50)
        cg.kill(dead.path)
        short = E.Escalator(cg, E.EscalationPolicy(max_attempts=1))
        with pytest.raises(E.EscalationExhausted) as exc:
            short.escalate(dead)
        assert exc.value.event is dead.oom
        led = E.WasteLedger()
        led.record_kill("a", attempt_pages=10, baseline_pages=300)
        led.record_kill("a", attempt_pages=20, baseline_pages=999)
        led.record_recovery("a")
        led.record_recovery("never_killed")
        return (freed, fields(negs), fields(ooms), lease.attempt,
                cg.read(lease.path, "memory.max"), cg.exists(dead.path),
                short.ledger.summary(), led.summary(),
                [(e.t_ms, e.kind.value, e.domain) for e in cg.log.events])
    t, j = both(run)
    assert t == j
    assert [n["grant_pages"] for n in t[1]] == [100, 200, 400]


class ScriptedCg:
    """A facade stand-in whose pressure files the test scripts (the
    reference tests' ``_ScriptedCg``), in either package."""

    def __init__(self, P, Ev, files):
        self.P, self.files, self.avg = P, dict(files), {}
        self.param_writes = []
        self.log = Ev.EventLog()

    def exists(self, p):
        return any(k[0] == p for k in self.files)

    def paths(self):
        return ["/"] + sorted({k[0] for k in self.files})

    def read(self, p, f):
        if f in self.P.PRESSURE_FILES:
            return self.P.format_psi(self.avg.get((p, f), 0.0), 0.0, 0)
        return self.files[(p, f)]

    def write(self, p, f, v):
        self.files[(p, f)] = v

    def update_params(self, p, kv):
        self.param_writes.append((p, dict(kv)))


# (initial files, config, [(poll time, {(path, file): avg10})])
ADAPTIVE_CASES = {
    "bump_restore": ({("/a", "memory.high"): 100,
                      ("/a", "memory.max"): 1 << 30},
                     dict(bump_factor=1.5, cooldown_ms=0.0),
                     [(0.0, {("/a", "memory.pressure"): 0.2}),
                      (1.0, {("/a", "memory.pressure"): 0.01}), (2.0, {})]),
    "max_wall": ({("/a", "memory.high"): 100, ("/a", "memory.max"): 120},
                 dict(bump_factor=2.0, cooldown_ms=0.0),
                 [(0.0, {("/a", "memory.pressure"): 0.9}), (1.0, {})]),
    "ceiling": ({("/a", "memory.high"): 100, ("/a", "memory.max"): 1 << 30},
                dict(bump_factor=2.0, max_bumps=2, cooldown_ms=0.0),
                [(0.0, {("/a", "memory.pressure"): 0.9}), (1.0, {}),
                 (2.0, {})]),
    "cooldown_dead_band": ({("/a", "memory.high"): 100,
                            ("/a", "memory.max"): 1 << 30},
                           dict(cooldown_ms=100.0),
                           [(0.0, {("/a", "memory.pressure"): 0.9}),
                            (50.0, {}), (100.0, {}),
                            (300.0, {("/a", "memory.pressure"): 0.10})]),
    "cpu_retune": ({("/a", "memory.high"): (1 << 31) - 1,
                    ("/a", "memory.max"): (1 << 31) - 1},
                   dict(cooldown_ms=0.0,
                        retune=(("sched_boost", 2.0, 1.0),)),
                   [(0.0, {("/a", "cpu.pressure"): 0.5,
                           ("/a", "memory.pressure"): 0.9}), (1.0, {}),
                    (2.0, {("/a", "cpu.pressure"): 0.0})]),
    "watch_default": ({("/a", "memory.high"): 10, ("/a/leaf",
                                                    "memory.high"): 10,
                       ("/b", "memory.high"): 10,
                       ("/b", "memory.max"): 40},
                      dict(cooldown_ms=0.0),
                      [(0.0, {("/b", "memory.pressure"): 0.5,
                              ("/a/leaf", "memory.pressure"): 0.5})]),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_controller(case):
    files, cfg, polls = ADAPTIVE_CASES[case]

    def run(A, C, D, E, Ev, I, P):
        cg = ScriptedCg(P, Ev, files)
        ctl = A.AdaptiveController(cg, A.AdaptiveConfig(**cfg))
        out = [ctl._watched()]
        for now, avg in polls:
            cg.avg.update(avg)
            out.append([(e.render(), e.t_ms) for e in ctl.poll(now)])
        return (out, cg.files, cg.param_writes,
                [(e.t_ms, e.kind.value, e.domain, sorted(e.detail.items()))
                 for e in cg.log.events])
    t, j = both(run)
    assert t == j
    assert any(t[0][1:])              # every case takes an action
