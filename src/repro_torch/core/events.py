"""Resource-control event log (the analogue of cgroup event counters +
AgentSight-style observability).

Every enforcement action — soft/hard breaches, throttles, freezes,
OOM kills, intent feedback — is appended here with a timestamp, so
benchmarks can reconstruct exactly what the controller did and when.

A pure-Python copy of ``repro/core/events.py``.
"""
from __future__ import annotations

import collections
import enum
from dataclasses import dataclass, field


class Ev(enum.Enum):
    CREATE = "create"
    REMOVE = "remove"
    CHARGE = "charge"
    CHARGE_FAIL = "charge_fail"
    HIGH_BREACH = "high_breach"     # soft limit crossed (memory.events high)
    MAX_BREACH = "max_breach"       # hard limit would be crossed
    THROTTLE = "throttle"           # allocation delayed (get_high_delay)
    FREEZE = "freeze"               # cgroup.freeze analogue
    THAW = "thaw"
    OOM_KILL = "oom_kill"           # memory.oom.group analogue
    EVICT = "evict"
    FEEDBACK = "feedback"           # downward intent channel fired
    ADMIT = "admit"
    DONE = "done"
    OOM = "oom"                     # semantic OOM delivered to a session
    REBUILD = "rebuild"             # backend rebuilt from snapshot
    PRESSURE = "pressure"           # adaptive retuner acted on PSI


@dataclass
class Event:
    t_ms: float
    kind: Ev
    domain: str
    detail: dict = field(default_factory=dict)


@dataclass(frozen=True)
class OomEvent:
    """Typed semantic OOM: what the agent's wrapper would parse out of
    an exit-137 + memcg ``memory.events`` read (the paper's §6
    ``bash_wrapper.sh`` loop), delivered in-band to the owning session
    so it can negotiate a retry instead of silently losing the call.
    """
    path: str                   # killed tool domain
    session: str                # owning session domain (lease parent)
    peak_pages: int             # memory.peak at kill time
    limit_pages: int            # the limit that triggered the kill
    attempt: int                # 1-based attempt number of the lease
    residual_pages: int         # pages freed by the kill (work discarded)
    t_ms: float = 0.0

    def render(self) -> str:
        return (f"[agentcgroup] OOM: {self.path} attempt {self.attempt} "
                f"killed at peak {self.peak_pages} pages "
                f"(limit {self.limit_pages}); {self.residual_pages} pages "
                f"of work discarded")


@dataclass(frozen=True)
class PressureEvent:
    """Typed adaptive-retune action: the closed-loop controller
    (``core/adaptive.py``) observed sustained pressure on a domain and
    turned a zero-retrace knob — a soft-limit bump, a parameter
    retune, or the reverse once pressure subsided."""
    path: str                   # domain acted on
    file: str                   # pressure file that triggered ("memory.pressure" / "cpu.pressure")
    avg10: float                # [0, 1] stall fraction at decision time
    action: str                 # "bump_high" | "restore_high" | "retune" | "restore_params"
    old: float                  # knob value before
    new: float                  # knob value after
    t_ms: float = 0.0

    def render(self) -> str:
        return (f"[agentcgroup] PRESSURE: {self.path} {self.file} "
                f"avg10={self.avg10 * 100.0:.2f}% -> {self.action} "
                f"{self.old:g} -> {self.new:g}")


class EventLog:
    def __init__(self) -> None:
        self.events: list[Event] = []

    def emit(self, t_ms: float, kind: Ev, domain: str, **detail) -> None:
        self.events.append(Event(t_ms, kind, domain, detail))

    def count(self, kind: Ev, domain_prefix: str = "") -> int:
        return sum(1 for e in self.events
                   if e.kind is kind and e.domain.startswith(domain_prefix))

    def of(self, kind: Ev, domain_prefix: str = "") -> list[Event]:
        return [e for e in self.events
                if e.kind is kind and e.domain.startswith(domain_prefix)]

    def counts(self) -> dict[str, int]:
        c: collections.Counter = collections.Counter(e.kind.value
                                                     for e in self.events)
        return dict(c)

    def clear(self) -> None:
        self.events.clear()
