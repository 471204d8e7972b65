"""Multi-tenant trace replay under a resource-control policy (paper §6).

Deterministic discrete-time simulation: each task's 1-second memory
samples become allocation/release deltas replayed at ``accel``x speed
(the paper replays at 50x).  The simulator provides the allocation
"physics" — base cost, direct-reclaim cost under pressure — and the
policy mediates every allocation (grant / throttle-delay / stall /
freeze / feedback / kill).

Measured outputs match Fig 8: per-task survival & completion, per-
priority allocation-latency P50/P95, throttle trigger counts, and
completion-time overhead vs an uncontended solo run.

Enforcement decisions run in the ``PolicyProgram`` attached to
``sim.cg`` — the literal same decision code the serving engine traces
on device — so replay results and in-step enforcement cannot drift.
Attach a custom program via ``Replay(..., program=...)`` (or let the
policy's ``setup`` do it); graduated delays arrive on the
``ChargeTicket`` and feed the backpressure physics below.

Port of ``repro/traces/replay.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import domains as D
from repro_torch.core.accounting import Accounting
from repro_torch.core.cgroup import AgentCgroup, HostTreeBackend
from repro_torch.core.escalation import (EscalationExhausted, Escalator,
                                         WasteLedger)
from repro_torch.core.events import Ev, EventLog
from repro_torch.core.policy import AllocOutcome, BasePolicy
from repro_torch.traces.schema import (AllocEvent, TaskTrace, ToolCall,
                                      to_alloc_events)


@dataclass
class ReplayConfig:
    capacity_mb: int
    accel: float = 50.0
    tick_ms: float = 2.0
    base_alloc_ms: float = 0.05
    # direct-reclaim stall: proportional to how far the pool sits over the
    # watermark when the allocation happens (scan work ~ deficit)
    reclaim_ms_per_deficit_mb: float = 0.30
    pressure_floor: float = 0.80        # watermark fraction of capacity
    # memory.low protection biases reclaim away from the protected cgroup
    # but does not eliminate the allocator's stall share
    protection_discount: float = 0.65
    max_sim_ms: float = 600_000.0
    max_events_per_tick: int = 64


@dataclass
class SimTask:
    key: str
    trace: TaskTrace
    priority: int
    events: list = field(default_factory=list)
    spans: list = field(default_factory=list)    # (start_ms, end_ms, call)
    idx: int = 0
    span_done: int = 0                           # spans fully closed
    open_span: int = -1                          # currently open span or -1
    next_due_ms: float = 0.0
    stall_since_ms: Optional[float] = None
    pending_mb: Optional[int] = None
    usage_mb: int = 0
    frozen: bool = False
    frozen_total_ms: float = 0.0
    frozen_since: float = 0.0
    done: bool = False
    killed: bool = False
    kill_reason: str = ""
    finish_ms: float = 0.0
    ideal_ms: float = 0.0
    scale_rest_of_tool: float = 1.0
    frozen_mb: int = 0                           # pages offloaded at freeze

    @property
    def running(self) -> bool:
        return not (self.done or self.killed)


@dataclass
class TaskResult:
    completed: bool
    killed: bool
    kill_reason: str
    finish_ms: float
    ideal_ms: float
    frozen_ms: float

    @property
    def overhead(self) -> float:
        if not self.completed or self.ideal_ms <= 0:
            return float("nan")
        return self.finish_ms / self.ideal_ms - 1.0


@dataclass
class ReplayResult:
    policy: str
    tasks: dict
    latency: Accounting
    log: EventLog
    peak_pool_mb: int
    escalation: Optional[dict] = None    # WasteLedger.summary() when active

    @property
    def survival(self) -> float:
        n = len(self.tasks)
        return sum(1 for r in self.tasks.values() if r.completed) / max(n, 1)

    def latency_of(self, priority: int):
        return self.latency.latency(f"prio{priority}")

    @property
    def throttle_count(self) -> int:
        return self.log.count(Ev.THROTTLE)

    def summary(self) -> dict:
        hi = self.latency_of(D.HIGH)
        return {
            "policy": self.policy,
            "survival": round(self.survival, 4),
            "high_p50_ms": round(hi.p50, 3),
            "high_p95_ms": round(hi.p95, 3),
            "throttles": self.throttle_count,
            "oom_kills": self.log.count(Ev.OOM_KILL),
            "freezes": self.log.count(Ev.FREEZE),
            "peak_pool_mb": self.peak_pool_mb,
        }


class Replay:
    def __init__(self, traces: list, priorities: list, policy: BasePolicy,
                 cfg: ReplayConfig, *, program=None, backend=None):
        """``backend``: any ``Backend`` to drive the replay through
        (default: a fresh host tree).  Lets the chaos harness run the
        whole simulation over a ``FaultyBackend`` — with a transient-
        only plan and auto-retry the results must be bit-identical to
        the default run."""
        assert len(traces) == len(priorities)
        self.cfg = cfg
        self.policy = policy
        self.cg = AgentCgroup(backend if backend is not None
                              else HostTreeBackend(cfg.capacity_mb))
        if program is not None:
            self.cg.attach("/", program)
        self.log = self.cg.log
        self.accounting = Accounting()
        self.now_ms = 0.0
        self.peak_pool = 0
        self.tasks: list[SimTask] = []
        for i, (tr, prio) in enumerate(zip(traces, priorities)):
            key = f"t{i}_{tr.task_id.replace('/', '_').replace('#', '_')}"
            ev = to_alloc_events(tr, accel=cfg.accel)
            spans = [(c.t_start_s * 1000.0 / cfg.accel,
                      c.t_end_s * 1000.0 / cfg.accel, c)
                     for c in sorted(tr.tool_calls, key=lambda c: c.t_start_s)]
            t = SimTask(key=key, trace=tr, priority=prio, events=ev,
                        spans=spans,
                        ideal_ms=(ev[-1].t_ms if ev else 0.0))
            t.next_due_ms = ev[0].t_ms if ev else 0.0
            self.tasks.append(t)
        # semantic OOM escalation: active only when the policy opts in
        # (baselines have no ``escalation`` attribute — nothing changes)
        esc_policy = getattr(policy, "escalation", None)
        self._escalator = (Escalator(self.cg, esc_policy, WasteLedger())
                           if esc_policy is not None else None)
        policy.setup(self, self.tasks)

    @property
    def waste_ledger(self) -> Optional[WasteLedger]:
        return self._escalator.ledger if self._escalator else None

    # ------------------------------------------------- policy-facing API

    def running_tasks(self) -> list:
        return [t for t in self.tasks if t.running and not t.frozen]

    def stall_ms(self, task: SimTask) -> float:
        return (self.now_ms - task.stall_since_ms
                if task.stall_since_ms is not None else 0.0)

    def current_call(self, task: SimTask) -> Optional[ToolCall]:
        if task.open_span >= 0:
            return task.spans[task.open_span][2]
        return None

    def kill_task(self, task: SimTask, reason: str, *,
                  allow_escalation: bool = True) -> None:
        """Kill the task's session domain.  With escalation active and
        an open tool lease, the kill is absorbed at tool-call
        granularity first: the lease is killed and retried at a
        negotiated limit, and only exhaustion kills the session."""
        if not task.running:
            return
        if (allow_escalation and self._escalator is not None
                and getattr(self.policy, "open_lease",
                            lambda t: None)(task) is not None):
            if self.escalate_tool_call(task):
                return                   # retry scheduled; task survives
            return                       # exhausted: task already killed
        path = self.policy.domain_for(task)
        if self.cg.exists(path):
            self.cg.kill(path)
        task.killed = True
        task.kill_reason = reason
        task.finish_ms = self.now_ms
        task.stall_since_ms = None
        task.pending_mb = None

    def escalate_tool_call(self, task: SimTask) -> bool:
        """Kill the task's open tool lease (delivering the typed
        ``OomEvent``) and retry the call at the negotiated limit:
        rewind the event cursor to the span start, schedule the retry
        after the jittered backoff.  Returns False when the attempt
        budget is exhausted — the task is then killed for real."""
        lease = self.policy.open_lease(task)
        if self._escalator is None or lease is None:
            self.kill_task(task, "memcg_max", allow_escalation=False)
            return False
        call_key = f"{task.key}:{lease.tool_id}"
        freed = self.cg.kill(lease.path) if not lease.killed else 0
        self._escalator.ledger.record_kill(
            call_key, attempt_pages=freed, baseline_pages=task.usage_mb)
        task.usage_mb = max(0, task.usage_mb - freed)
        try:
            new_lease, neg = self._escalator.escalate(lease)
        except EscalationExhausted:
            self.policy.replace_lease(task, None)
            self.kill_task(task, "escalation_exhausted",
                           allow_escalation=False)
            return False
        self.policy.replace_lease(task, new_lease)
        # rewind to the span start: the retry replays the tool call's
        # allocations under the new limit (the kill released them all)
        if task.open_span >= 0:
            s, _, _ = task.spans[task.open_span]
            while task.idx > 0 and task.events[task.idx - 1].t_ms >= s:
                task.idx -= 1
        task.pending_mb = None
        task.stall_since_ms = None
        task.next_due_ms = self.now_ms + neg.backoff_ms
        return True

    def frozen_tasks(self) -> list:
        return [t for t in self.tasks if t.running and t.frozen]

    def freeze_task(self, task: SimTask) -> None:
        """Freeze = cgroup.freeze + OFFLOAD: the session's pool pages move
        to host swap (core/freezer semantics), releasing the contended
        resource while preserving the session's context."""
        if task.frozen:
            return
        path = self.policy.domain_for(task)
        usage = self.cg.usage(path)
        task.frozen_mb = usage
        if usage:
            self.cg.uncharge(path, usage)
        self.cg.freeze(path)
        task.frozen = True
        task.frozen_since = self.now_ms

    def thaw_task(self, task: SimTask) -> bool:
        """Thaw = re-charge the offloaded pages + resume.  Fails (stays
        frozen) if the pool cannot host the pages again yet."""
        if not task.frozen:
            return True
        if task.frozen_mb > self.cg.free():
            return False            # no headroom yet; stay frozen quietly
        path = self.policy.domain_for(task)
        self.cg.thaw(path)
        if task.frozen_mb:
            ticket = self.cg.try_charge(path, task.frozen_mb)
            if not ticket.granted:
                self.cg.freeze(path)
                return False
        task.frozen_mb = 0
        task.frozen = False
        task.frozen_total_ms += self.now_ms - task.frozen_since
        task.next_due_ms = max(task.next_due_ms, self.now_ms)
        return True

    # ------------------------------------------------------------ physics

    def _grant_latency(self, mb: int, protected: bool) -> float:
        """Allocation physics: base cost + direct-reclaim under pressure.

        ``protected`` = the domain is under below-``low`` protection and
        the policy already did the reclaim work proactively (by
        throttling siblings) — the allocation skips direct reclaim, the
        mechanism behind Fig 8(b)'s HIGH-priority latency win."""
        cfg = self.cfg
        floor_mb = cfg.pressure_floor * self.cg.capacity
        deficit = self.cg.usage("/") - floor_mb
        lat = cfg.base_alloc_ms
        if deficit > 0:
            scale = cfg.protection_discount if protected else 1.0
            lat += scale * cfg.reclaim_ms_per_deficit_mb * deficit
        return lat

    # --------------------------------------------------------------- run

    def _sync_spans(self, task: SimTask, t_local_ms: float) -> None:
        """Open/close tool spans as the task's local clock passes them."""
        if task.open_span >= 0:
            s, e, call = task.spans[task.open_span]
            if t_local_ms >= e:
                self.policy.on_tool_end(self, task, call)
                task.scale_rest_of_tool = 1.0
                task.span_done = task.open_span + 1
                task.open_span = -1
        while task.open_span < 0 and task.span_done < len(task.spans):
            s, e, call = task.spans[task.span_done]
            if t_local_ms < s:
                break
            self.policy.on_tool_start(self, task, call)
            if t_local_ms < e:
                task.open_span = task.span_done
                break
            # span passed entirely between two events: fire start+end
            self.policy.on_tool_end(self, task, call)
            task.scale_rest_of_tool = 1.0
            task.span_done += 1

    def _process_event(self, task: SimTask) -> bool:
        """Try the task's next event.  True if it was consumed."""
        ev: AllocEvent = task.events[task.idx]
        self._sync_spans(task, ev.t_ms)
        if ev.delta_mb >= 0:
            mb = task.pending_mb
            if mb is None:
                mb = max(0, int(round(ev.delta_mb * task.scale_rest_of_tool)))
            if mb == 0:
                task.idx += 1
                task.pending_mb = None
                task.stall_since_ms = None
                if task.idx < len(task.events):
                    gap = task.events[task.idx].t_ms - ev.t_ms
                    task.next_due_ms = self.now_ms + gap
                return True
            out: AllocOutcome = self.policy.on_alloc(self, task, mb)
            if out.granted:
                stall = self.stall_ms(task)
                phys = self._grant_latency(mb, out.protected)
                lat = stall + out.delay_ms + phys
                self.accounting.record_alloc(f"prio{task.priority}",
                                             self.now_ms, lat)
                self.accounting.record_alloc("root", self.now_ms,
                                             lat if lat > 1e-3 else 0.0)
                task.usage_mb += mb
                task.stall_since_ms = None
                task.pending_mb = None
                task.idx += 1
                # backpressure: the task itself is delayed by its stall
                delay = out.delay_ms + phys
                if task.idx < len(task.events):
                    gap = task.events[task.idx].t_ms - ev.t_ms
                    task.next_due_ms = self.now_ms + gap + delay
                return True
            # not granted
            if task.killed or out.kill:
                # killed outright, or the call was escalated: the event
                # cursor/backoff were already reset — don't stall
                return False
            task.pending_mb = mb
            if task.stall_since_ms is None:
                task.stall_since_ms = self.now_ms
            if out.feedback is not None:
                # strategy reconstruction: retry with reduced scope
                agent = getattr(self.policy, "agent_model", None)
                if agent is not None:
                    adj = agent.on_feedback(
                        getattr(ev.tool, "category", "unknown"), out.feedback)
                    task.scale_rest_of_tool = adj["scale"]
                    task.pending_mb = max(1, int(mb * adj["scale"]))
            return False
        # release
        mb = min(int(round(-ev.delta_mb)), task.usage_mb)
        if mb > 0:
            self.policy.on_release(self, task, mb)
            task.usage_mb -= mb
        task.idx += 1
        task.pending_mb = None
        task.stall_since_ms = None
        if task.idx < len(task.events):
            gap = task.events[task.idx].t_ms - ev.t_ms
            task.next_due_ms = self.now_ms + gap
        return True

    def run(self) -> ReplayResult:
        cfg = self.cfg
        while any(t.running for t in self.tasks) and self.now_ms < cfg.max_sim_ms:
            self.now_ms += cfg.tick_ms
            self.cg.set_time(self.now_ms)
            for task in self.tasks:
                if not task.running or task.frozen:
                    continue
                n = 0
                while (task.running and not task.frozen
                       and task.idx < len(task.events)
                       and task.next_due_ms <= self.now_ms
                       and n < cfg.max_events_per_tick):
                    if not self._process_event(task):
                        # stalled: PSI sees the ongoing stall this tick
                        self.accounting.record_alloc("root", self.now_ms,
                                                     cfg.tick_ms)
                        break
                    n += 1
                if task.running and task.idx >= len(task.events):
                    task.done = True
                    task.finish_ms = self.now_ms
                    self.policy.on_task_end(self, task)
                    self.log.emit(self.now_ms, Ev.DONE, task.key)
            self.peak_pool = max(self.peak_pool, self.cg.usage("/"))
            self.policy.tick(self)
        results = {
            t.key: TaskResult(completed=t.done, killed=t.killed,
                              kill_reason=t.kill_reason,
                              finish_ms=t.finish_ms, ideal_ms=t.ideal_ms,
                              frozen_ms=t.frozen_total_ms)
            for t in self.tasks
        }
        return ReplayResult(self.policy.name, results, self.accounting,
                            self.log, self.peak_pool,
                            escalation=(self._escalator.ledger.summary()
                                        if self._escalator else None))


def replay(traces: list, priorities: list, policy: BasePolicy,
           cfg: ReplayConfig) -> ReplayResult:
    return Replay(traces, priorities, policy, cfg).run()
