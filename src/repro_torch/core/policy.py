"""Resource-control policies for the trace-replay harness.

One class per row of the paper's Table 2, plus AgentCgroup itself:

  * ``NoIsolationPolicy``   — the Fig-8 baseline: one shared pool, kernel
    OOM-kills the largest consumer when allocations stall too long.
  * ``StaticLimitPolicy``   — memory.max per container: peak-sized limits
    waste >90 % of reservation; average-sized limits OOM on bursts
    (granularity mismatch).
  * ``ReactivePSIPolicy``   — systemd-oomd/Meta-oomd analogue: a daemon
    polls PSI and kills, but poll + reaction latency lands *after* the
    1-2 s bursts (responsiveness mismatch).
  * ``PredictiveP95Policy`` — Autopilot/VPA analogue: limits from
    historical P95s, defeated by 1.8x-20x non-determinism (adaptability
    mismatch).
  * ``AgentCgroupPolicy``   — the paper's system: hierarchical tool-call
    domains + intent hints (upward), graduated in-kernel enforcement
    throttle -> freeze -> feedback-retry (downward), kill only as last
    resort.

Policies drive the unified ``AgentCgroup`` control plane owned by the
simulator (``sim.cg`` — ``core/cgroup.py``), never a raw tree; the
simulator provides the allocation-latency physics (reclaim costs) and
calls back on tool-span boundaries and ticks.

Since the ``PolicyProgram`` redesign the per-allocation *decision*
(grant / deny / graduated delay) is no longer computed here: it runs in
the program attached to ``sim.cg`` — the same code the device backends
trace — and arrives on the ``ChargeTicket``.  What stays host-side is
exactly the paper's user-space daemon work: domain lifecycle, limit
sizing, kill/freeze selection, and the intent channel.

Port of ``repro/core/policy.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import domains as D
from repro_torch.core.cgroup import DomainSpec
from repro_torch.core.intent import (CATEGORY_HINT, AdaptiveAgentModel,
                                     Feedback, hint_to_high)
from repro_torch.core.progs import PolicyProgram


@dataclass
class AllocOutcome:
    granted: bool
    delay_ms: float = 0.0
    kill: bool = False
    freeze: bool = False
    feedback: Optional[Feedback] = None
    protected: bool = False     # below-``low`` fast path (skips direct reclaim)


class BasePolicy:
    name = "base"
    hierarchical = False

    def setup(self, sim, tasks) -> None:
        for t in tasks:
            sim.cg.mkdir(self.domain_for(t), DomainSpec(priority=t.priority))

    def domain_for(self, task) -> str:
        return f"/{task.key}"

    def on_tool_start(self, sim, task, call) -> None:
        pass

    def on_tool_end(self, sim, task, call) -> None:
        pass

    def charge_path(self, sim, task) -> str:
        return self.domain_for(task)

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        raise NotImplementedError

    def on_release(self, sim, task, mb: int) -> None:
        sim.cg.uncharge(self.charge_path(sim, task), mb)

    def tick(self, sim) -> None:
        pass

    def on_task_end(self, sim, task) -> None:
        path = self.domain_for(task)
        usage = sim.cg.usage(path)
        if usage:
            sim.cg.uncharge(path, usage)

    # admission control: how many tasks fit concurrently (for the
    # mismatch benchmark's concurrency-density comparison)
    def max_concurrency(self, capacity_mb: int, per_task_mb: float) -> int:
        return max(1, int(capacity_mb // max(per_task_mb, 1)))


# --------------------------------------------------------------- baselines


class NoIsolationPolicy(BasePolicy):
    """Shared pool, no domains below root; kernel global OOM heuristic."""
    name = "no_isolation"

    def __init__(self, oom_after_ms: float = 120.0):
        self.oom_after_ms = oom_after_ms

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        ticket = sim.cg.try_charge(self.charge_path(sim, task), mb)
        if ticket.granted:
            return AllocOutcome(True)
        # pool exhausted: stall; the kernel OOMs the largest consumer
        # once the stall exceeds its patience
        if sim.stall_ms(task) > self.oom_after_ms:
            victim = max(sim.running_tasks(),
                         key=lambda t: sim.cg.usage(self.domain_for(t)))
            sim.kill_task(victim, reason="global_oom")
            return AllocOutcome(False)
        return AllocOutcome(False)


class StaticLimitPolicy(BasePolicy):
    """memory.max per container (K8s Guaranteed-style)."""
    name = "static_limit"

    def __init__(self, limit_mb: int):
        self.limit_mb = limit_mb

    def setup(self, sim, tasks) -> None:
        for t in tasks:
            sim.cg.mkdir(self.domain_for(t),
                         DomainSpec(max=self.limit_mb, priority=t.priority))

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        ticket = sim.cg.try_charge(self.charge_path(sim, task), mb)
        if ticket.granted:
            return AllocOutcome(True)
        if ticket.blocked_by == self.domain_for(task):
            # the container's own memory.max: immediate OOM kill
            sim.kill_task(task, reason="memory.max")
            return AllocOutcome(False, kill=True)
        return AllocOutcome(False)

    def max_concurrency(self, capacity_mb: int, per_task_mb: float) -> int:
        return max(1, int(capacity_mb // self.limit_mb))


class ReactivePSIPolicy(BasePolicy):
    """PSI-watching user-space OOM daemon (oomd / systemd-oomd)."""
    name = "reactive_psi"

    def __init__(self, poll_ms: float = 100.0, react_ms: float = 40.0,
                 pressure_threshold: float = 0.4):
        self.poll_ms = poll_ms
        self.react_ms = react_ms
        self.threshold = pressure_threshold
        self._last_poll = 0.0
        self._pending_kill_at: Optional[float] = None

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        ticket = sim.cg.try_charge(self.charge_path(sim, task), mb)
        return AllocOutcome(ticket.granted)

    def tick(self, sim) -> None:
        now = sim.now_ms
        if self._pending_kill_at is not None and now >= self._pending_kill_at:
            self._pending_kill_at = None
            lows = [t for t in sim.running_tasks() if t.priority == D.LOW]
            if lows:
                victim = max(lows,
                             key=lambda t: sim.cg.usage(self.domain_for(t)))
                sim.kill_task(victim, reason="oomd_psi")
        if now - self._last_poll < self.poll_ms:
            return
        self._last_poll = now
        if sim.accounting.pressure("root", now) > self.threshold:
            # daemon wakes, decides, writes cgroup.kill — react_ms later
            if self._pending_kill_at is None:
                self._pending_kill_at = now + self.react_ms


class PredictiveP95Policy(StaticLimitPolicy):
    """Autopilot-style: per-task limit = P95 of historical peaks."""
    name = "predictive_p95"

    def __init__(self, history_peaks_mb: dict, safety: float = 1.1,
                 default_mb: int = 600):
        self.history = history_peaks_mb
        self.safety = safety
        self.default_mb = default_mb
        self.limit_mb = default_mb       # updated per task at setup

    def setup(self, sim, tasks) -> None:
        self.limits = {}
        for t in tasks:
            hist = self.history.get(t.trace.task_id)
            lim = (int(np.percentile(hist, 95) * self.safety)
                   if hist else self.default_mb)
            self.limits[t.key] = lim
            sim.cg.mkdir(self.domain_for(t),
                         DomainSpec(max=lim, priority=t.priority))

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        ticket = sim.cg.try_charge(self.charge_path(sim, task), mb)
        if ticket.granted:
            return AllocOutcome(True)
        if ticket.blocked_by == self.domain_for(task):
            sim.kill_task(task, reason="predicted_limit")
            return AllocOutcome(False, kill=True)
        return AllocOutcome(False)


# ------------------------------------------------------------- AgentCgroup


class AgentCgroupPolicy(BasePolicy):
    """The paper's system (§5): hierarchical tool-call domains, intent
    hints, graduated in-kernel enforcement throttle -> freeze ->
    feedback, kill last.  Tool-call domains open and close through the
    control plane's ``IntentChannel`` leases."""
    name = "agentcgroup"
    hierarchical = True

    def __init__(self, *, session_high: Optional[dict] = None,
                 use_intent: bool = True,
                 freeze_threshold: float = 0.97, thaw_threshold: float = 0.80,
                 hard_patience_ms: float = 150.0,
                 agent_model: Optional[AdaptiveAgentModel] = None,
                 program: Optional[PolicyProgram] = None,
                 escalation=None,
                 lease_max_factor: Optional[float] = None):
        # graduated-throttle constants live in the attached program
        # (domains.BASE_DELAY_MS etc. by default) — not duplicated here
        self.session_high = session_high or {}
        self.use_intent = use_intent
        self.freeze_threshold = freeze_threshold
        self.thaw_threshold = thaw_threshold
        self.hard_patience_ms = hard_patience_ms
        self.agent_model = agent_model or AdaptiveAgentModel()
        self.program = program
        # semantic OOM escalation (core/escalation.py): when
        # ``lease_max_factor`` is set, tool leases carry a hard
        # ``memory.max`` = factor * high; a breach kills the lease and —
        # with an ``EscalationPolicy`` — retries it at a negotiated
        # higher limit instead of killing the task (both default off,
        # preserving the established replay outputs bit-for-bit)
        self.escalation = escalation
        self.lease_max_factor = lease_max_factor
        self._lease: dict = {}          # task.key -> open tool Lease
        self._tool_seq = 0

    def setup(self, sim, tasks) -> None:
        if self.program is not None:
            sim.cg.attach("/", self.program)
        for t in tasks:
            # session_high keyed by task_id (paper: LOW sessions get
            # memory.high = 400 MB, HIGH gets memory.high = max)
            high = self.session_high.get(t.trace.task_id, D.UNLIMITED)
            low = 0
            if t.priority == D.HIGH:
                # below_low protection for the latency-sensitive session
                low = int(t.trace.peak_mb * 1.05)
            sim.cg.mkdir(self.domain_for(t),
                         DomainSpec(high=high, low=low, priority=t.priority))

    # --- fine-grained domains at tool-call boundaries (bash-wrapper analogue)

    def on_tool_start(self, sim, task, call) -> None:
        self._tool_seq += 1
        hint = None
        if self.use_intent:
            declared = CATEGORY_HINT.get(call.category)
            hint = self.agent_model.hint_for(call.category, declared)
        high = hint_to_high(hint)
        lease_max = D.UNLIMITED
        if self.lease_max_factor is not None:
            lease_max = max(1, int(high * self.lease_max_factor))
        self._lease[task.key] = sim.cg.intent.declare(
            f"tool_{self._tool_seq}", hint, parent=self.domain_for(task),
            priority=task.priority, high=high, max=lease_max)

    def on_tool_end(self, sim, task, call) -> None:
        lease = self._lease.pop(task.key, None)
        if lease is not None:
            if lease.attempt > 1 and not lease.killed:
                # an escalated retry ran to completion — recovered
                esc = getattr(sim, "_escalator", None)
                if esc is not None:
                    esc.ledger.record_recovery(f"{task.key}:{lease.tool_id}")
            # lease close logs memory.peak and moves retained memory up
            # to the session (retry accumulation)
            lease.close()

    def open_lease(self, task):
        return self._lease.get(task.key)

    def replace_lease(self, task, lease) -> None:
        if lease is None:
            self._lease.pop(task.key, None)
        else:
            self._lease[task.key] = lease

    def charge_path(self, sim, task) -> str:
        lease = self._lease.get(task.key)
        return lease.path if lease is not None else self.domain_for(task)

    def on_release(self, sim, task, mb: int) -> None:
        path = self.charge_path(sim, task)
        take = min(mb, sim.cg.usage(path))
        if take:
            sim.cg.uncharge(path, take)
        rest = mb - take
        if rest > 0 and path != self.domain_for(task):
            sim.cg.uncharge(self.domain_for(task), rest)

    # --- graduated in-kernel enforcement

    def on_alloc(self, sim, task, mb: int) -> AllocOutcome:
        path = self.charge_path(sim, task)
        ticket = sim.cg.try_charge(path, mb)
        if ticket.granted:
            # graduated delay comes straight off the ticket — computed
            # by the attached program, the same decision code the
            # device backends run in-step
            delay = ticket.delay_ms
            # below_low protection: the HIGH session's allocations skip
            # direct reclaim — sibling throttling did the work already
            sess = self.domain_for(task)
            protected = (task.priority == D.HIGH
                         and sim.cg.usage(sess)
                         <= sim.cg.read(sess, "memory.low"))
            return AllocOutcome(True, delay_ms=delay, protected=protected)
        # memcg-max breach on the tool lease itself: kill the CALL (not
        # the task) and — when escalation is on — retry it at a
        # negotiated higher limit (the paper's exit-137 -> retry loop)
        lease = self._lease.get(task.key)
        if (lease is not None and ticket.blocked_by == lease.path
                and lease.max < D.UNLIMITED
                and sim.cg.usage(lease.path) + mb > lease.max):
            if self.escalation is not None:
                sim.escalate_tool_call(task)
            else:
                # no-retry baseline: a hard tool limit is fatal
                sim.kill_task(task, reason="memcg_max_tool",
                              allow_escalation=False)
            return AllocOutcome(False, kill=True)
        # hard denial: stall; after patience, feedback-retry (strategy
        # reconstruction) instead of killing
        if sim.stall_ms(task) > self.hard_patience_ms:
            fb = sim.cg.intent.feedback(
                path, "oom", peak=sim.cg.peak(path),
                limit=sim.cg.read(path, "memory.max"))
            return AllocOutcome(False, feedback=fb)
        return AllocOutcome(False)

    # --- daemon: freeze under extreme pressure, thaw when it clears

    def tick(self, sim) -> None:
        usage, cap = sim.cg.usage("/"), sim.cg.capacity
        frozen = sim.frozen_tasks()
        if usage > self.freeze_threshold * cap:
            cands = [t for t in sim.running_tasks() if t.priority == D.LOW]
            if cands:
                victim = max(cands,
                             key=lambda t: sim.cg.usage(self.domain_for(t)))
                sim.freeze_task(victim)
        elif frozen:
            # thaw only when the re-charge will not immediately push the
            # pool back over the freeze threshold (hysteresis)
            cand = min(frozen, key=lambda t: t.frozen_mb)
            if usage + cand.frozen_mb < self.thaw_threshold * cap:
                sim.thaw_task(cand)
