"""Backend-conformance kit: one declarative op vocabulary, any backend.

Backend parity checks share one reusable kit instead of ad-hoc op
lists.  A ``Scenario`` is a declarative op sequence; ``replay()`` drives
it through the ``AgentCgroup`` facade against any backend and records
every *observable* (grants, stalls, delays, residuals, reads, plus a
final usage/peak audit of the whole tree); ``ConformanceSuite.run()``
replays each scenario against the backend under test AND a reference
backend (the host tree — the reference semantics) and diffs the
observation streams.  A new ``Backend`` implementation certifies
itself with one parametrized fixture:

    suite = ConformanceSuite()
    report = suite.run(standard_backend_factory("async-device"))
    assert report.ok, report.summary()

Scenarios cover the memcg contract (charge/uncharge, hard-max walls,
freeze -> thaw re-charge, residual transfer on rmdir, subtree kill),
policy programs (graduated throttle windows, token-bucket pacing,
attach scoping, live retunes), the intent channel (lease open /
feedback / close), control files, and memcg event counters (feature
``"events"`` — only backends with full host-side counters run it).

Authoring new scenarios: write the op tuples directly, or drive a live
``AgentCgroup`` through an ``OpRecorder`` and call ``to_scenario()``.

Op vocabulary (``(name, *args)`` tuples; ``charge`` without an explicit
step runs on the op-index step clock):

    ("mkdir", path[, {spec kwargs}])        ("rmdir", path[, transfer])*
    ("charge", path, amt[, step])*          ("uncharge", path, amt)
    ("unchecked", path, amt)                ("kill", path)*
    ("freeze", path)  ("thaw", path)        ("write", path, file, value)
    ("read", path, file)*                   ("usage", path)* ("peak", path)*
    ("exists", path)*                       ("attach", scope, prog_key)
    ("update_params", path, {kv})           ("set_time", t)
    ("lease_open", tool, hint|None, parent[, {kw}])
    ("lease_feedback", tool, reason)*       ("lease_close", tool)*
    ("schedule", paths, costs, budget[, step])*
    ("adaptive", now[, {AdaptiveConfig kwargs}])*
    ("flush",)

The ``adaptive`` op polls a scenario-scoped ``AdaptiveController``
(created on first use from the op's config kwargs) and records the
rendered ``PressureEvent`` actions — the closed loop replayed through
the same public surface on every backend.

Starred ops record an observation; every replay ends with a flush (a
no-op on synchronous backends) and the final tree audit, so async
backends are compared at an epoch boundary — their bit-exactness
contract.

Port of ``repro/testing/conformance.py``: the same scenarios and
observation streams, over all six backend kinds (``host``, ``device``,
``sharded`` and the ``async-*`` daemon around each) and the
fault-injecting ``faulty_backend_factory``.  The device-state kinds
build their tables on the card unless the factory is given
``device="cpu"``; the sharded kinds take ``n_shards`` (default 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core import domains as D
from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                     DomainSpec, HostTreeBackend)
from repro_torch.core.daemon import AsyncDaemonBackend
from repro_torch.core.events import Ev
from repro_torch.core.faults import FaultyBackend
from repro_torch.core.intent import Hint
from repro_torch.core.progs import GraduatedThrottleProgram, TokenBucketProgram
from repro_torch.core.sharded import ShardedTableBackend

__all__ = ["Scenario", "ConformanceSuite", "ConformanceReport",
           "ScenarioResult", "OpRecorder", "replay", "get_scenario",
           "standard_backend_factory", "faulty_backend_factory",
           "backend_features", "BACKEND_KINDS", "STANDARD_SCENARIOS"]

# Event kinds every backend emits identically (lifecycle + intent).
# Breach/throttle counters (HIGH_BREACH/MAX_BREACH/THROTTLE) live
# in-step on the device backends, so they only appear host-side and are
# compared via the feature-gated full stream instead.
PORTABLE_EVENT_KINDS = frozenset({Ev.CREATE, Ev.REMOVE, Ev.FREEZE, Ev.THAW,
                                  Ev.OOM_KILL, Ev.OOM, Ev.FEEDBACK, Ev.DONE,
                                  Ev.PRESSURE})


# --------------------------------------------------------------- scenarios


@dataclass(frozen=True)
class Scenario:
    """A named, declarative op sequence plus the programs it attaches."""
    name: str
    ops: tuple
    programs: dict = field(default_factory=dict)     # key -> () -> program
    capacity: int = 500
    n_domains: int = 16
    requires: frozenset = frozenset()                # backend feature flags
    description: str = ""
    # PSI meter window override (avg10, avg60) in facade-clock units —
    # scenarios exercising pressure decay use short horizons so rises
    # and restores happen within a replayable op count
    pressure_windows: Optional[tuple] = None


def replay(cg: AgentCgroup, scenario: Scenario) -> list:
    """Drive ``scenario`` through the facade; return the observation
    stream ``[(op_idx, op_name, value), ...]`` ending with the final
    usage/peak audit of every surviving path (op_idx -1)."""
    obs: list = []
    leases: dict = {}
    adaptive = None
    if scenario.pressure_windows is not None:
        cg.pressure_clock(windows=scenario.pressure_windows)
    for i, op in enumerate(scenario.ops):
        name, *a = op
        if name == "mkdir":
            cg.mkdir(a[0], DomainSpec(**(a[1] if len(a) > 1 else {})))
        elif name == "charge":
            step = a[2] if len(a) > 2 else i
            t = cg.try_charge(a[0], a[1], step=step)
            obs.append((i, "charge",
                        (t.granted, t.stalled, round(t.delay_ms, 3))))
        elif name == "uncharge":
            cg.uncharge(a[0], a[1])
        elif name == "unchecked":
            cg.charge_unchecked(a[0], a[1])
        elif name == "freeze":
            cg.freeze(a[0])
        elif name == "thaw":
            cg.thaw(a[0])
        elif name == "kill":
            obs.append((i, "kill", cg.kill(a[0])))
        elif name == "rmdir":
            transfer = a[1] if len(a) > 1 else True
            obs.append((i, "rmdir",
                        cg.rmdir(a[0], transfer_residual=transfer)))
        elif name == "write":
            cg.write(a[0], a[1], a[2])
        elif name == "read":
            obs.append((i, "read", (a[0], a[1], cg.read(a[0], a[1]))))
        elif name == "usage":
            obs.append((i, "usage", (a[0], cg.usage(a[0]))))
        elif name == "peak":
            obs.append((i, "peak", (a[0], cg.peak(a[0]))))
        elif name == "exists":
            obs.append((i, "exists", (a[0], cg.exists(a[0]))))
        elif name == "attach":
            cg.attach(a[0], scenario.programs[a[1]]())
        elif name == "update_params":
            cg.update_params(a[0], **a[1])
        elif name == "set_time":
            cg.set_time(a[0])
        elif name == "lease_open":
            hint = Hint[a[1]] if a[1] else None
            kw = a[3] if len(a) > 3 else {}
            leases[a[0]] = cg.intent.declare(a[0], hint, parent=a[2], **kw)
        elif name == "lease_feedback":
            fb = leases[a[0]].feedback(a[1])
            obs.append((i, "lease_feedback",
                        (fb.reason, fb.peak_pages, fb.limit_pages)))
        elif name == "lease_close":
            obs.append((i, "lease_close", leases[a[0]].close()))
        elif name == "schedule":
            step = a[3] if len(a) > 3 else i
            adv = cg.schedule(list(a[0]), list(a[1]), step, a[2])
            obs.append((i, "schedule", tuple(bool(x) for x in adv)))
        elif name == "adaptive":
            if adaptive is None:
                from repro_torch.core.adaptive import (AdaptiveConfig,
                                                 AdaptiveController)
                adaptive = AdaptiveController(
                    cg, AdaptiveConfig(**(a[1] if len(a) > 1 else {})))
            acts = adaptive.poll(a[0])
            if acts:                 # quiet polls record nothing
                obs.append((i, "adaptive",
                            tuple(e.render() for e in acts)))
        elif name == "flush":
            cg.flush()
        else:
            raise ValueError(f"unknown conformance op {name!r}")
    cg.flush()                     # epoch boundary: async == sync from here
    for path in sorted(cg.paths()):
        obs.append((-1, "final", (path, cg.usage(path), cg.peak(path))))
    # event-log audit (kind sequences, never timestamps): the portable
    # lifecycle stream is compared on every backend; the full stream
    # (breach/throttle counters) only where the backend surfaces it
    events = list(cg.log.events)
    obs.append((-2, "events_lifecycle",
                tuple((e.kind.value, e.domain) for e in events
                      if e.kind in PORTABLE_EVENT_KINDS)))
    obs.append((-2, "events_all",
                tuple((e.kind.value, e.domain) for e in events)))
    return obs


class OpRecorder:
    """Records facade calls into a declarative op list that ``replay``
    reproduces — drive a live ``AgentCgroup`` once, keep the scenario."""

    def __init__(self, cg: AgentCgroup):
        self.cg = cg
        self.ops: list = []

    def mkdir(self, path: str, **kw) -> int:
        self.ops.append(("mkdir", path, dict(kw)))
        return self.cg.mkdir(path, DomainSpec(**kw))

    def try_charge(self, path: str, pages: int, step: Optional[int] = None):
        # the step (explicit None = facade clock) replays verbatim
        self.ops.append(("charge", path, pages, step))
        return self.cg.try_charge(path, pages, step=step)

    def uncharge(self, path: str, pages: int) -> None:
        self.ops.append(("uncharge", path, pages))
        self.cg.uncharge(path, pages)

    def charge_unchecked(self, path: str, pages: int) -> None:
        self.ops.append(("unchecked", path, pages))
        self.cg.charge_unchecked(path, pages)

    def freeze(self, path: str) -> None:
        self.ops.append(("freeze", path))
        self.cg.freeze(path)

    def thaw(self, path: str) -> None:
        self.ops.append(("thaw", path))
        self.cg.thaw(path)

    def kill(self, path: str) -> int:
        self.ops.append(("kill", path))
        return self.cg.kill(path)

    def rmdir(self, path: str, *, transfer_residual: bool = True) -> int:
        self.ops.append(("rmdir", path, transfer_residual))
        return self.cg.rmdir(path, transfer_residual=transfer_residual)

    def write(self, path: str, file: str, value) -> None:
        self.ops.append(("write", path, file, value))
        self.cg.write(path, file, value)

    def read(self, path: str, file: str):
        self.ops.append(("read", path, file))
        return self.cg.read(path, file)

    def to_scenario(self, name: str, **kw) -> Scenario:
        return Scenario(name=name, ops=tuple(self.ops), **kw)


# ----------------------------------------------------- standard scenarios


def _zero_delay() -> GraduatedThrottleProgram:
    """Grant/deny semantics isolated from op timing."""
    return GraduatedThrottleProgram(base_delay_ms=0.0, max_delay_ms=0.0)


def _weighted_fair():
    """Scheduler semantics isolated from throttle timing."""
    from repro_torch.core.sched import WeightedFairProgram
    return WeightedFairProgram(base_delay_ms=0.0, max_delay_ms=0.0)


def _sched_rounds(paths: tuple, costs: tuple, budget: int,
                  steps) -> tuple:
    return tuple(("schedule", paths, costs, budget, s) for s in steps)


def _throttling_fair():
    """Weighted scheduler WITH the stock graduated throttle — the
    pressure scenarios need real stall events on both resources."""
    from repro_torch.core.sched import WeightedFairProgram
    return WeightedFairProgram()


def _pressure_ramp_ops() -> tuple:
    """Stalls on both resources under a ticking facade clock, with the
    PSI file surface read at three probe times."""
    ops = [("attach", "/", "wfair_t"),
           ("mkdir", "/t"),
           ("mkdir", "/t/a", {"high": 40}),
           ("mkdir", "/t/b", {"max": 100, "priority": D.LOW})]
    for t in range(20):
        ops.append(("set_time", float(t * 10)))
        ops.append(("charge", "/t/a", 10, t))     # over high=40 from t=4
        ops.append(("charge", "/t/b", 20, t))     # max=100 wall from t=5
        # 1-cost budget: the losing slot is a CPU-stall event
        ops.append(("schedule", ("/t/a", "/t/b"), (1, 1), 1, t))
        if t in (5, 10, 19):
            for f in ("memory.stall", "cpu.stall",
                      "memory.pressure", "cpu.pressure"):
                ops.append(("read", "/t", f))
            ops.append(("read", "/t/a", "memory.pressure"))
    return tuple(ops)


# the adaptive scenario's closed-loop config: bump /t/a's soft limit
# under sustained memory pressure (2x per bump, hard-capped by
# memory.max), restore once pressure decays below the low threshold
_ADAPTIVE_CFG = {"high_frac": 0.15, "low_frac": 0.05, "bump_factor": 2.0,
                 "max_bumps": 3, "cooldown_ms": 40.0, "watch": ("/t/a",)}


def _adaptive_retune_ops() -> tuple:
    ops = [("attach", "/", "wfair_t"),
           ("mkdir", "/t"),
           ("mkdir", "/t/a", {"high": 40, "max": 200})]
    for t in range(30):               # pressured phase: stall every step
        ops.append(("set_time", float(t * 10)))
        ops.append(("charge", "/t/a", 8, t))
        ops.append(("adaptive", float(t * 10), _ADAPTIVE_CFG))
    ops.append(("read", "/t/a", "memory.high"))
    for t in range(30, 80):           # calm phase: pressure decays
        ops.append(("set_time", float(t * 10)))
        ops.append(("adaptive", float(t * 10), _ADAPTIVE_CFG))
    ops.append(("read", "/t/a", "memory.high"))
    ops.append(("read", "/t/a", "memory.stall"))
    return tuple(ops)


def _std_tree(*extra) -> tuple:
    return (("mkdir", "/t"),
            ("mkdir", "/t/a", {"high": 120}),
            ("mkdir", "/t/b", {"max": 200, "priority": D.LOW}),
            ("mkdir", "/t/a/tool", {"high": 40})) + extra


_AUDIT = (("usage", "/"), ("usage", "/t"), ("usage", "/t/a"),
          ("usage", "/t/b"), ("peak", "/"), ("peak", "/t"),
          ("peak", "/t/a"), ("peak", "/t/b"))

STANDARD_SCENARIOS: tuple = (
    Scenario(
        "lifecycle",
        description="the canonical charge/deny/uncharge/freeze/thaw/"
                    "rmdir-residual/unchecked sequence (PR-2 golden ops)",
        programs={"zero": _zero_delay},
        ops=(("attach", "/", "zero"),) + _std_tree(
            ("charge", "/t/a/tool", 60),      # grant; over tool high
            ("charge", "/t/b", 150),          # grant
            ("charge", "/t/b", 100),          # deny: /t/b max=200
            ("uncharge", "/t/b", 50),
            ("charge", "/t/b", 100),          # grant now
            ("freeze", "/t/a"),
            ("charge", "/t/a/tool", 5),       # deny: frozen ancestor
            ("thaw", "/t/a"),
            ("charge", "/t/a/tool", 5),       # grant again
            ("rmdir", "/t/a/tool"),           # residual 65 -> /t/a
            ("unchecked", "/t/a", 20),        # lifecycle bookkeeping
            ("uncharge", "/t/a", 30),
            ("charge", "/t/a", 400),          # deny: root capacity 500
        ) + _AUDIT),
    Scenario(
        "residual_transfer",
        description="closing a non-empty tool domain keeps its pages "
                    "accounted to the session chain",
        programs={"zero": _zero_delay},
        ops=(("attach", "/", "zero"),
             ("mkdir", "/s"), ("mkdir", "/s/tool", {"high": 40}),
             ("charge", "/s/tool", 30),
             ("rmdir", "/s/tool"),
             ("exists", "/s/tool"),
             ("usage", "/s"), ("usage", "/"))),
    Scenario(
        "rmdir_release",
        programs={"zero": _zero_delay},
        ops=(("attach", "/", "zero"),
             ("mkdir", "/s"), ("mkdir", "/s/tool"),
             ("charge", "/s/tool", 30),
             ("rmdir", "/s/tool", False),
             ("usage", "/s"), ("usage", "/"))),
    Scenario(
        "freeze_thaw_recharge",
        description="the engine's freeze path: offload (uncharge) + "
                    "freeze, then thaw + unchecked re-charge round-trips",
        programs={"zero": _zero_delay},
        ops=(("attach", "/", "zero"),
             ("mkdir", "/s"), ("mkdir", "/s/sess"),
             ("charge", "/s/sess", 80),
             ("usage", "/"), ("usage", "/s"), ("usage", "/s/sess"),
             ("uncharge", "/s/sess", 80),
             ("freeze", "/s/sess"),
             ("charge", "/s/sess", 1),        # deny: frozen
             ("usage", "/"),
             ("thaw", "/s/sess"),
             ("unchecked", "/s/sess", 80),
             ("usage", "/"), ("usage", "/s"), ("usage", "/s/sess"))),
    Scenario(
        "kill_subtree",
        description="killed domains stay registered and deny charges",
        programs={"zero": _zero_delay},
        ops=(("attach", "/", "zero"),
             ("mkdir", "/s"), ("mkdir", "/s/a"),
             ("charge", "/s/a", 40), ("charge", "/s", 10),
             ("kill", "/s"),
             ("usage", "/"),
             ("exists", "/s"), ("exists", "/s/a"),
             ("charge", "/s", 5), ("charge", "/s/a", 5))),
    Scenario(
        "graduated_throttle",
        description="over-high charges impose graduated windows; charges "
                    "inside a window stall; windows expire with the clock",
        programs={"grad": GraduatedThrottleProgram},
        ops=(("attach", "/", "grad"),) + _std_tree(
            ("charge", "/t/a/tool", 60, 0),   # over tool high=40 -> window
            ("charge", "/t/a/tool", 5, 1),    # inside the window
            ("charge", "/t/b", 150, 2),
            ("charge", "/t/b", 100, 3),       # max=200 wall
            ("charge", "/t/b", 30, 4),
            ("charge", "/t/a/tool", 5, 8),
            ("charge", "/t/a/tool", 5, 12),   # after the window
            ("charge", "/t/b", 10, 20),
        ) + _AUDIT),
    Scenario(
        "token_bucket",
        description="pages-per-step pacing with per-priority refill, "
                    "across multiple tenant subtrees (multi-shard when "
                    "the backend shards)",
        programs={"bucket": lambda: TokenBucketProgram(
            bucket_capacity=16, refill=(1.0, 2.0, 4.0))},
        capacity=10_000,
        ops=(("attach", "/", "bucket"),
             ("mkdir", "/t0"), ("mkdir", "/t1"), ("mkdir", "/t2"),
             ("mkdir", "/t2/s", {"priority": D.LOW}),
             ("charge", "/t2", 16, 0),        # drains /t2's bucket
             ("charge", "/t2", 8, 1),
             ("charge", "/t2", 4, 2),
             ("charge", "/t2", 2, 3),
             ("charge", "/t0", 16, 4),
             ("charge", "/t2", 30, 5),
             ("charge", "/t2/s", 16, 6),
             ("charge", "/t2/s", 2, 7),       # LOW refill: 1/step
             ("charge", "/t1", 16, 8),
             ("usage", "/"), ("usage", "/t0"), ("usage", "/t1"),
             ("usage", "/t2"))),
    Scenario(
        "attach_retune",
        description="update_params writes the subtree; new children "
                    "inherit the parent's live row",
        programs={"grad": GraduatedThrottleProgram},
        ops=(("attach", "/", "grad"),
             ("mkdir", "/t"), ("mkdir", "/t/a", {"high": 40}),
             ("update_params", "/t", {"base_delay_ms": 40.0}),
             ("mkdir", "/t/a/kid", {"high": 10}),
             ("charge", "/t/a/kid", 20, 0),   # over 1.0 -> 40*(1+10) = 440
             ("charge", "/t/a/kid", 1, 5),    # inside the window
             ("charge", "/t/a/kid", 1, 60),   # window (44 steps) expired
             ("update_params", "/", {"base_delay_ms": 0.0,
                                     "max_delay_ms": 0.0}),
             ("charge", "/t/a/kid", 50, 61))),
    Scenario(
        "attach_scope",
        description="a subtree attach composes: only in-scope domains "
                    "switch to the attached program; out-of-scope domains "
                    "keep the program (and live row) they already had",
        programs={"bucket4": lambda: TokenBucketProgram(
            bucket_capacity=4, refill=(1.0, 1.0, 1.0))},
        capacity=10_000,
        ops=(("mkdir", "/scoped"), ("mkdir", "/free"),
             ("attach", "/scoped", "bucket4"),
             ("charge", "/scoped", 50, 0),    # deny: bucketed
             ("charge", "/free", 50, 0))),    # grant: prior program kept
    Scenario(
        "multi_program",
        description="two tenants run different policy programs "
                    "concurrently in one hierarchy: a subtree attach "
                    "gives /bkt the token bucket while /grad keeps the "
                    "graduated root program; children created after the "
                    "attach inherit the parent's program slot, and "
                    "update_params resolves each path through its own "
                    "program's parameter columns",
        programs={"grad": GraduatedThrottleProgram,
                  "bucket4": lambda: TokenBucketProgram(
                      bucket_capacity=4, refill=(1.0, 1.0, 1.0))},
        capacity=10_000,
        ops=(("attach", "/", "grad"),
             ("mkdir", "/grad"), ("mkdir", "/bkt"),
             ("attach", "/bkt", "bucket4"),
             ("mkdir", "/grad/s", {"high": 10}),
             ("mkdir", "/bkt/s"),             # inherits the bucket slot
             ("charge", "/bkt/s", 6, 0),      # deny: bucket holds 4
             ("charge", "/bkt/s", 3, 0),      # grant: within the bucket
             ("charge", "/grad/s", 20, 0),    # grant + graduated throttle
             ("charge", "/grad/s", 1, 1),     # deny: inside the window
             ("update_params", "/bkt", {"bucket_capacity": 50.0,
                                        "bucket_level": 50.0}),
             ("charge", "/bkt/s", 30, 5),     # grant: retuned bucket
             ("update_params", "/grad", {"base_delay_ms": 0.0,
                                         "max_delay_ms": 0.0}),
             ("charge", "/grad/s", 1, 200),   # grant: throttle retuned off
             ("usage", "/"), ("usage", "/grad"), ("usage", "/bkt"))),
    Scenario(
        "memcg_events",
        description="full memcg event counters (host-class backends)",
        requires=frozenset({"events"}),
        programs={"grad": GraduatedThrottleProgram},
        ops=(("attach", "/", "grad"),
             ("mkdir", "/s", {"high": 10, "max": 50}),
             ("charge", "/s", 20, 0),         # high breach + throttle
             ("charge", "/s", 100, 1),        # max breach
             ("read", "/s", "memory.events"))),
    Scenario(
        "intent_lease",
        description="lease lifecycle: hint-derived high, feedback "
                    "record, residual moves up on close, idempotent",
        ops=(("mkdir", "/sess"),
             ("lease_open", "tool_1", "LOW", "/sess"),
             ("exists", "/sess/tool_1"),
             ("read", "/sess/tool_1", "memory.high"),
             ("charge", "/sess/tool_1", 25),
             ("lease_feedback", "tool_1", "throttled"),
             ("lease_close", "tool_1"),
             ("exists", "/sess/tool_1"),
             ("usage", "/sess"),
             ("lease_close", "tool_1"))),     # idempotent: 0
    Scenario(
        "control_files",
        description="the cgroupfs file surface, including freeze-by-write",
        ops=(("mkdir", "/s", {"high": 100, "max": 200, "low": 10,
                              "priority": D.HIGH}),
             ("read", "/s", "memory.high"), ("read", "/s", "memory.max"),
             ("read", "/s", "memory.low"),
             ("read", "/s", "memory.priority"),
             ("write", "/s", "memory.high", 50),
             ("read", "/s", "memory.high"),
             ("write", "/s", "cgroup.freeze", 1),
             ("read", "/s", "cgroup.freeze"),
             ("charge", "/s", 1),             # deny: frozen
             ("write", "/s", "cgroup.freeze", 0),
             ("charge", "/s", 1))),           # grant
    Scenario(
        "cpu_weight_fair",
        description="weighted step scheduler: a 300/100 cpu.weight split "
                    "grants 3:1 under a 1-slot budget; a live cpu.weight "
                    "write rebalances with vruntime carried across steps",
        programs={"wfair": _weighted_fair},
        ops=(("attach", "/", "wfair"),
             ("mkdir", "/a", {"weight": 300}),
             ("mkdir", "/b", {"weight": 100}),
             ("read", "/a", "cpu.weight"), ("read", "/b", "cpu.weight"),
             ("read", "/a", "cpu.max"))
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(8))
            + (("write", "/b", "cpu.weight", 300),
               ("read", "/b", "cpu.weight"))
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(8, 16))),
    Scenario(
        "cpu_max_quota",
        description="cpu.max as a hard per-window throttle: the capped "
                    "tenant stops advancing once its window quota is "
                    "spent and resumes at the next window (never on the "
                    "root — per-shard roots make that quota diverge)",
        programs={"wfair": _weighted_fair},
        ops=(("attach", "/", "wfair"),
             ("mkdir", "/t"),
             ("mkdir", "/t/a", {"cpu_max": 3}),
             ("mkdir", "/t/b"),
             ("read", "/t/a", "cpu.max"))
            + _sched_rounds(("/t/a", "/t/b"), (1, 1), 8, range(6))
            + _sched_rounds(("/t/a", "/t/b"), (1, 1), 8, (100, 101))),
    Scenario(
        "sched_retune",
        description="update_params(sched_boost=...) retunes a tenant's "
                    "effective weight live — the zero-retrace knob — and "
                    "freeze removes a slot from the runnable set",
        programs={"wfair": _weighted_fair},
        ops=(("attach", "/", "wfair"),
             ("mkdir", "/a"), ("mkdir", "/b"))
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(4))
            + (("update_params", "/a", {"sched_boost": 2.0}),)
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(4, 14))
            + (("freeze", "/a"),)
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(14, 17))
            + (("thaw", "/a"),)
            + _sched_rounds(("/a", "/b"), (1, 1), 1, range(17, 20))),
    Scenario(
        "pressure_ramp",
        description="PSI-style pressure accounting: stall events from "
                    "throttled charges, max-wall denials and lost "
                    "scheduling rounds accumulate per domain, roll up "
                    "the hierarchy, and render identical avg10/avg60 "
                    "strings on every backend",
        programs={"wfair_t": _throttling_fair},
        pressure_windows=(200.0, 1000.0),
        ops=_pressure_ramp_ops()),
    Scenario(
        "adaptive_retune",
        description="closed loop over the public PSI surface: sustained "
                    "memory pressure bumps memory.high (never past "
                    "memory.max), decay restores it — with hysteresis "
                    "and per-domain cooldown",
        programs={"wfair_t": _throttling_fair},
        pressure_windows=(200.0, 1000.0),
        ops=_adaptive_retune_ops()),
)

_BY_NAME = {s.name: s for s in STANDARD_SCENARIOS}


def get_scenario(name: str) -> Scenario:
    return _BY_NAME[name]


# ------------------------------------------------------ factories/features

BACKEND_KINDS = ("host", "device", "sharded",
                 "async-host", "async-device", "async-sharded")


def standard_backend_factory(kind: str, *, device="cuda",
                             n_domains: Optional[int] = None,
                             n_shards: int = 1) -> Callable:
    """``kind -> (capacity, n_domains) -> Backend`` for the repo's four
    backend families (``async-*`` wraps the named inner backend).
    ``device`` places the device-state kinds' tables (the card unless
    ``"cpu"`` is given); ``n_domains`` overrides the scenarios' table
    size, per shard for the sharded kinds (the same answers must come
    back at any size); ``n_shards`` is the sharded kinds' shard count."""
    if kind not in BACKEND_KINDS:
        raise ValueError(f"unknown backend kind {kind!r}")

    def make(capacity: int, n: int):
        if kind == "host":
            return HostTreeBackend(capacity)
        if kind == "device":
            return DeviceTableBackend(capacity, n_domains=n_domains or n,
                                      device=device)
        if kind == "sharded":
            return ShardedTableBackend(capacity, n_domains=n_domains or n,
                                       n_shards=n_shards, device=device)
        inner = standard_backend_factory(
            kind[len("async-"):], device=device, n_domains=n_domains,
            n_shards=n_shards)(capacity, n)
        return AsyncDaemonBackend(inner)

    make.kind = kind
    return make


def faulty_backend_factory(kind: str, plan=None, *, auto_retry: int = 0,
                           on_spurious_kill: Optional[Callable] = None,
                           device="cuda", n_domains: Optional[int] = None,
                           n_shards: int = 1) -> Callable:
    """``FaultyBackend``-wrapped variant of a standard backend kind.
    The wrapper sits directly around the synchronous inner backend, so
    for ``async-*`` kinds injected faults fire on the daemon thread (a
    wedge there poisons the daemon, the realistic failure mode).  With
    the default fault-free plan the factory must pass the conformance
    suite bit-exact.  ``device``, ``n_domains`` and ``n_shards`` as for
    ``standard_backend_factory``."""
    if kind not in BACKEND_KINDS:
        raise ValueError(f"unknown backend kind {kind!r}")
    inner_kind = kind[len("async-"):] if kind.startswith("async-") else kind
    inner = standard_backend_factory(inner_kind, device=device,
                                     n_domains=n_domains, n_shards=n_shards)

    def make(capacity: int, n: int):
        faulty = FaultyBackend(inner(capacity, n), plan,
                               auto_retry=auto_retry,
                               on_spurious_kill=on_spurious_kill)
        if kind.startswith("async-"):
            return AsyncDaemonBackend(faulty)
        return faulty

    make.kind = f"faulty-{kind}"
    return make


def backend_features(kind: str) -> frozenset:
    """Feature flags a standard backend supports: the host tree (and the
    async daemon over it) surfaces full memcg event counters."""
    return frozenset({"events"}) if kind.endswith("host") else frozenset()


# ----------------------------------------------------------------- runner


@dataclass
class ScenarioResult:
    name: str
    ok: bool
    skipped: bool = False
    mismatches: list = field(default_factory=list)


@dataclass
class ConformanceReport:
    backend: str
    results: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def summary(self) -> str:
        lines = [f"conformance[{self.backend}]:"]
        for r in self.results:
            if r.skipped:
                lines.append(f"  {r.name}: SKIPPED (missing feature)")
            elif r.ok:
                lines.append(f"  {r.name}: ok")
            else:
                lines.append(f"  {r.name}: {len(r.mismatches)} mismatch(es)")
                lines.extend(f"    {m}" for m in r.mismatches[:8])
        return "\n".join(lines)


class ConformanceSuite:
    """Replays scenarios against a backend under test and the reference
    backend, diffing observation streams.  Reference observations are
    cached per scenario, so one suite instance can certify many
    backends cheaply."""

    def __init__(self, scenarios: Optional[Sequence[Scenario]] = None,
                 reference: Optional[Callable] = None):
        self.scenarios = (list(scenarios) if scenarios is not None
                          else list(STANDARD_SCENARIOS))
        self.reference = reference or (lambda cap, n: HostTreeBackend(cap))
        self._ref_obs: dict[str, list] = {}

    def _reference_obs(self, scenario: Scenario) -> list:
        if scenario.name not in self._ref_obs:
            backend = self.reference(scenario.capacity, scenario.n_domains)
            try:
                self._ref_obs[scenario.name] = replay(AgentCgroup(backend),
                                                      scenario)
            finally:
                close = getattr(backend, "close", None)
                if close is not None:
                    close()
        return self._ref_obs[scenario.name]

    def run(self, backend_factory: Callable, *,
            features: frozenset = frozenset(),
            scenarios: Optional[Sequence[str]] = None,
            raise_on_failure: bool = False) -> ConformanceReport:
        name = getattr(backend_factory, "kind",
                       getattr(backend_factory, "__name__", "backend"))
        report = ConformanceReport(backend=name)
        for sc in self.scenarios:
            if scenarios is not None and sc.name not in scenarios:
                continue
            if not sc.requires <= frozenset(features):
                report.results.append(ScenarioResult(sc.name, True,
                                                     skipped=True))
                continue
            backend = backend_factory(sc.capacity, sc.n_domains)
            try:
                got = replay(AgentCgroup(backend), sc)
            finally:
                close = getattr(backend, "close", None)
                if close is not None:
                    close()                  # stop async daemon threads
            want = self._reference_obs(sc)
            # the full event stream includes host-only breach/throttle
            # kinds — only comparable when the backend surfaces them
            if "events" not in features:
                got = [r for r in got if r[1] != "events_all"]
                want = [r for r in want if r[1] != "events_all"]
            mism = [f"op {gi}/{gn}: got {gv!r} want {wv!r}"
                    for (gi, gn, gv), (wi, wn, wv) in zip(got, want)
                    if (gi, gn, gv) != (wi, wn, wv)]
            if len(got) != len(want):
                mism.append(f"observation count {len(got)} != {len(want)}")
            report.results.append(ScenarioResult(sc.name, not mism,
                                                 mismatches=mism))
        if raise_on_failure and not report.ok:
            raise AssertionError(report.summary())
        return report
