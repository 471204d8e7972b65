"""Semantic OOM escalation: negotiate, re-declare, retry (paper §6).

The paper's waste-reduction claim rests on agents *recovering* from
enforcement, not just being contained by it: its exemplar
``bash_wrapper.sh`` watches for exit-137, reads ``memory.events``, and
injects a structured message so the agent retries with a different
strategy.  This module is the structural version of that loop:

  1. ``AgentCgroup.kill`` on a tool lease delivers a typed ``OomEvent``
     (events.py) to the owning session via the intent channel.
  2. ``EscalationPolicy.negotiate`` turns the event into a bounded
     grant: exponential limit growth from the observed peak, capped by
     the tightest ancestor ``memory.max`` (you can never be granted
     more than the hierarchy could admit), with deterministic jittered
     backoff on the facade clock.
  3. ``Escalator.escalate`` closes the killed lease (no DONE — the kill
     already accounted the call) and re-declares the same tool id at
     the negotiated limit, attempt+1.
  4. ``WasteLedger`` accounts what the loop buys: pages of discarded
     work per attempt vs. the no-retry baseline that throws away the
     whole task.

Attempts are bounded; exhaustion raises ``EscalationExhausted`` — the
loud-failure half of the robustness contract (a caller must either
recover or know it didn't).

Port of ``repro/core/escalation.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import domains as D
from repro_torch.core.cgroup import AgentCgroup, Lease
from repro_torch.core.events import OomEvent

UNLIMITED = D.UNLIMITED


class EscalationExhausted(RuntimeError):
    """The retry budget is spent (or the hierarchy has no headroom):
    the tool call is permanently lost.  Carries the last OomEvent."""

    def __init__(self, ev: OomEvent, msg: str):
        super().__init__(msg)
        self.event = ev


@dataclass(frozen=True)
class Negotiation:
    """One negotiated retry: the new hard limit and when to start."""
    grant_pages: int
    backoff_ms: float
    attempt: int                # attempt number the retry will run as


@dataclass(frozen=True)
class EscalationPolicy:
    """Bounded exponential limit negotiation with jittered backoff.

    The negotiated grant is ``max(limit*growth, peak*headroom)`` —
    growth from the *limit* guarantees progress even when the kill
    fired before the peak got near the limit; headroom over the *peak*
    skips futile intermediate attempts when the observed need is
    already known.  Jitter is deterministic (hash of lease key and
    attempt), so replays are bit-reproducible."""
    max_attempts: int = 4
    growth: float = 2.0
    headroom: float = 1.25
    base_backoff_ms: float = 20.0
    backoff_factor: float = 2.0
    jitter_frac: float = 0.25

    def _jitter(self, key: str, attempt: int) -> float:
        """Deterministic in [0, 1): replays never depend on wall clock."""
        return zlib.crc32(f"{key}#{attempt}".encode()) / 2**32

    def backoff_ms(self, key: str, attempt: int) -> float:
        base = self.base_backoff_ms * self.backoff_factor ** (attempt - 1)
        return base * (1.0 + self.jitter_frac * self._jitter(key, attempt))

    def negotiate(self, ev: OomEvent,
                  parent_max: int) -> Optional[Negotiation]:
        """The grant for the next attempt, or None when exhausted
        (attempt budget spent, or the cap allows no further growth)."""
        if ev.attempt >= self.max_attempts:
            return None
        want = max(int(ev.limit_pages * self.growth),
                   int(ev.peak_pages * self.headroom),
                   ev.limit_pages + 1)
        grant = min(want, parent_max)
        if grant <= ev.limit_pages:
            return None              # already at the hierarchy's ceiling
        return Negotiation(grant_pages=grant,
                           backoff_ms=self.backoff_ms(ev.path, ev.attempt),
                           attempt=ev.attempt + 1)


@dataclass
class WasteLedger:
    """Accounts what escalation buys vs. a no-retry baseline.

    Per killed attempt we discard only that attempt's resident pages
    (``attempt_waste``); the no-retry baseline discards the whole
    task's resident set and gives up (``baseline_waste``).  A recovered
    call is one that later completed at a negotiated limit."""
    kills: int = 0
    exhausted: int = 0
    attempt_waste_pages: int = 0
    baseline_waste_pages: int = 0
    _killed: set = field(default_factory=set)
    _recovered: set = field(default_factory=set)

    def record_kill(self, key: str, attempt_pages: int,
                    baseline_pages: int) -> None:
        self.kills += 1
        self.attempt_waste_pages += int(attempt_pages)
        if key not in self._killed:      # baseline dies on the FIRST kill
            self.baseline_waste_pages += int(baseline_pages)
        self._killed.add(key)

    def record_recovery(self, key: str) -> None:
        if key in self._killed:
            self._recovered.add(key)

    def record_exhausted(self, key: str) -> None:
        self.exhausted += 1

    @property
    def killed_calls(self) -> int:
        return len(self._killed)

    @property
    def recovered_calls(self) -> int:
        return len(self._recovered)

    @property
    def recovery_rate(self) -> float:
        return self.recovered_calls / max(self.killed_calls, 1)

    @property
    def saved_pages(self) -> int:
        """Work the baseline would have discarded but escalation kept."""
        return max(self.baseline_waste_pages - self.attempt_waste_pages, 0)

    def summary(self) -> dict:
        return {"killed_calls": self.killed_calls,
                "recovered_calls": self.recovered_calls,
                "recovery_rate": self.recovery_rate,
                "kills": self.kills, "exhausted": self.exhausted,
                "attempt_waste_pages": self.attempt_waste_pages,
                "baseline_waste_pages": self.baseline_waste_pages,
                "saved_pages": self.saved_pages}


class Escalator:
    """Binds a policy to a facade: turn a killed lease into a retried
    one.  The negotiation cap is the tightest ancestor ``memory.max``
    above the lease (the limit the hierarchy could actually admit)."""

    def __init__(self, cg: AgentCgroup,
                 policy: Optional[EscalationPolicy] = None,
                 ledger: Optional[WasteLedger] = None):
        self.cg = cg
        self.policy = policy if policy is not None else EscalationPolicy()
        self.ledger = ledger if ledger is not None else WasteLedger()

    def _ancestor_cap(self, path: str) -> int:
        cap = UNLIMITED
        for anc in AgentCgroup.ancestors(path):
            m = self.cg.read(anc, "memory.max")
            if m < cap:
                cap = m
        return cap

    def escalate(self, lease: Lease) -> tuple[Lease, Negotiation]:
        """Close the killed ``lease`` and re-declare it at the
        negotiated limit.  Raises ``EscalationExhausted`` when the
        policy yields no further grant (the lease is still closed, so
        the session's accounting stays clean)."""
        ev = lease.oom
        assert ev is not None, f"lease {lease.path} was not killed"
        neg = self.policy.negotiate(ev, self._ancestor_cap(lease.parent))
        if neg is None:
            lease.close()
            self.ledger.record_exhausted(lease.path)
            raise EscalationExhausted(
                ev, f"{lease.path}: no grant after attempt {ev.attempt} "
                    f"(peak {ev.peak_pages}, limit {ev.limit_pages})")
        lease.close()                    # killed: no DONE, frees the slot
        new = self.cg.intent.declare(
            lease.tool_id, lease.hint, parent=lease.parent,
            priority=lease.priority, high=neg.grant_pages,
            max=neg.grant_pages, attempt=neg.attempt)
        return new, neg
