"""Hierarchical resource domains — the cgroup v2 analogue.

The tree mirrors cgroup v2 semantics with *pages* (KV-cache pages /
MB in trace replay) as the charge unit:

  * charges propagate to every ancestor (memcg hierarchical accounting);
  * ``max`` is a hard wall: a charge that would cross ANY ancestor's
    ``max`` fails atomically (nothing is committed) — the memcg
    try_charge contract;
  * ``high`` is a soft throttle point: charges succeed but the breach is
    reported so the controller can apply allocator delays
    (memory.high + memcg_bpf_ops.get_high_delay_ms);
  * ``low`` is protection: while a domain is below ``low``, the
    controller refrains from throttling/reclaiming it when *siblings*
    cause pressure (memory.low / the paper's ``below_low`` guard);
  * ``freeze``/``thaw`` stop a subtree (cgroup.freeze);
  * ``kill`` atomically removes a subtree's charges (cgroup.kill +
    memory.oom.group — no partial failures).

A pure-Python copy of ``repro/core/domains.py`` (the port imports
nothing of the JAX package).  ``core/controller.py`` holds the
device-resident torch mirror the serving engine charges in-step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.core.events import Ev, EventLog

UNLIMITED = (1 << 31) - 1          # int32-safe "no limit" sentinel

# priorities
LOW, NORMAL, HIGH = 0, 1, 2

# cpu.weight default (cgroup v2: weights in [1, 10000], default 100)
DEFAULT_WEIGHT = 100

# Graduated-throttle defaults (get_high_delay_ms curve) — the single
# source for ``ControllerConfig``, ``GraduatedThrottleProgram``, and the
# host tree's reference ``throttle_delay_ms``.
BASE_DELAY_MS = 10.0
MAX_DELAY_MS = 2000.0
OVERAGE_GAIN = 10.0
HIGH_PRIORITY_DISCOUNT = 0.1


@dataclass
class Domain:
    name: str                      # full path, e.g. "/t0/sess1/tool_7"
    parent: Optional["Domain"]
    high: int = UNLIMITED          # soft limit (pages)
    max: int = UNLIMITED           # hard limit (pages)
    low: int = 0                   # protected floor (pages)
    priority: int = NORMAL
    usage: int = 0
    peak: int = 0
    frozen: bool = False
    killed: bool = False
    # CPU scheduling (cpu.weight / cpu.max — the sched_ext half)
    weight: int = DEFAULT_WEIGHT   # cpu.weight (1..10000)
    cpu_max: int = UNLIMITED       # cpu.max: step-cost quota per window
    flat_weight: float = 0.0       # flattened hierarchical weight (root 1.0)
    vruntime: float = 0.0          # weighted-fair account
    cpu_used: int = 0              # window usage (lazy reset via stamp)
    cpu_stamp: int = -1            # window index cpu_used belongs to
    # program-imposed throttle deadline (clock units of the caller —
    # see HostTreeBackend.try_charge); DomainTree itself never gates on
    # it, the attached PolicyProgram does
    throttle_until: float = 0.0
    children: dict = field(default_factory=dict)
    # event counters (memory.events analogue)
    n_high_breach: int = 0
    n_max_breach: int = 0
    n_throttle: int = 0
    n_oom_kill: int = 0
    # PSI stall-event counters (memory.pressure / cpu.pressure, see
    # core/pressure.py) — local to the domain; subtree aggregation
    # happens host-side at read rate
    mem_stall: int = 0
    cpu_stall: int = 0

    def ancestors(self) -> Iterable["Domain"]:
        d: Optional[Domain] = self
        while d is not None:
            yield d
            d = d.parent

    @property
    def depth(self) -> int:
        return 0 if self.parent is None else self.parent.depth + 1

    @property
    def over_high(self) -> int:
        return max(0, self.usage - self.high)

    @property
    def protected(self) -> bool:
        return self.usage <= self.low


@dataclass
class ChargeResult:
    ok: bool
    blocked_by: Optional[str] = None        # domain whose max blocked it
    over_high: tuple = ()                   # domains whose high is breached


class DomainTree:
    def __init__(self, capacity: int, log: Optional[EventLog] = None):
        """capacity: root hard limit (total pool pages)."""
        self.root = Domain("/", None, max=capacity, high=capacity)
        self._index: dict[str, Domain] = {"/": self.root}
        self.log = log if log is not None else EventLog()
        self.now_ms = 0.0

    # ------------------------------------------------------------ lifecycle

    def create(self, path: str, *, high: int = UNLIMITED, max: int = UNLIMITED,
               low: int = 0, priority: int = NORMAL,
               weight: int = DEFAULT_WEIGHT,
               cpu_max: int = UNLIMITED) -> Domain:
        assert path.startswith("/") and path not in self._index, path
        parent_path = path.rsplit("/", 1)[0] or "/"
        parent = self._index[parent_path]
        d = Domain(path, parent, high=high, max=max, low=low,
                   priority=priority, weight=weight, cpu_max=cpu_max)
        parent.children[path] = d
        self._index[path] = d
        self.log.emit(self.now_ms, Ev.CREATE, path, high=high, max=max)
        return d

    def remove(self, path: str) -> None:
        """Remove an (empty) domain, returning residual charges upward."""
        d = self._index[path]
        assert not d.children, f"{path} has children"
        if d.usage:
            self._uncharge_from(d, d.usage)
        del d.parent.children[path]
        del self._index[path]
        self.log.emit(self.now_ms, Ev.REMOVE, path)

    def get(self, path: str) -> Domain:
        return self._index[path]

    def exists(self, path: str) -> bool:
        return path in self._index

    def subtree(self, path: str) -> list[Domain]:
        d = self._index[path]
        out = [d]
        stack = list(d.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    # ------------------------------------------------------------- charging

    def blocking_ancestor(self, d: Domain, pages: int) -> Optional[Domain]:
        """First (self-first) ancestor whose ``max`` the charge would
        cross, or None."""
        for a in d.ancestors():
            if a.usage + pages > a.max:
                return a
        return None

    def note_max_breach(self, a: Domain, pages: int) -> None:
        """memcg event bookkeeping for a hard-``max`` denial."""
        a.n_max_breach += 1
        self.log.emit(self.now_ms, Ev.MAX_BREACH, a.name,
                      want=pages, usage=a.usage, max=a.max)

    def commit_charge(self, d: Domain, pages: int) -> tuple:
        """Commit a granted charge up the chain: usage/peak plus the
        ``high``-breach counters and event.  Returns the over-``high``
        domain names.  Shared by ``try_charge`` and the program-driven
        ``HostTreeBackend`` — one copy of the memcg bookkeeping."""
        over = []
        for a in d.ancestors():
            a.usage += pages
            a.peak = max(a.peak, a.usage)
            if a.usage > a.high:
                a.n_high_breach += 1
                over.append(a.name)
        if over:
            self.log.emit(self.now_ms, Ev.HIGH_BREACH, over[0],
                          domains=tuple(over), want=pages)
        return tuple(over)

    def try_charge(self, path: str, pages: int) -> ChargeResult:
        """Atomic hierarchical charge (memcg try_charge contract)."""
        d = self._index[path]
        if d.frozen or d.killed:
            return ChargeResult(False, blocked_by=path)
        blk = self.blocking_ancestor(d, pages)
        if blk is not None:
            self.note_max_breach(blk, pages)
            return ChargeResult(False, blocked_by=blk.name)
        return ChargeResult(True, over_high=self.commit_charge(d, pages))

    def uncharge(self, path: str, pages: int) -> None:
        self._uncharge_from(self._index[path], pages)

    def _uncharge_from(self, d: Domain, pages: int) -> None:
        pages = min(pages, d.usage)
        for a in d.ancestors():
            a.usage = max(0, a.usage - pages)

    # ------------------------------------------------------ freeze / kill

    def freeze(self, path: str) -> None:
        for d in self.subtree(path):
            d.frozen = True
        self.log.emit(self.now_ms, Ev.FREEZE, path)

    def thaw(self, path: str) -> None:
        for d in self.subtree(path):
            d.frozen = False
        self.log.emit(self.now_ms, Ev.THAW, path)

    def kill(self, path: str) -> int:
        """Atomic subtree kill (memory.oom.group): releases all charges.
        Returns pages freed."""
        d = self._index[path]
        freed = d.usage
        self._uncharge_from(d, d.usage)
        for n in self.subtree(path):
            n.killed = True
            n.usage = 0
            n.n_oom_kill += 1
        self.log.emit(self.now_ms, Ev.OOM_KILL, path, freed=freed)
        return freed

    # ----------------------------------------------------------- queries

    def free(self) -> int:
        return self.root.max - self.root.usage

    def usage(self, path: str = "/") -> int:
        return self._index[path].usage

    def throttle_delay_ms(self, path: str, *,
                          base_delay_ms: float = BASE_DELAY_MS,
                          max_delay_ms: float = MAX_DELAY_MS) -> float:
        """get_high_delay_ms analogue: graduated delay for over-``high``
        domains, scaled by relative overage, respecting ``low``
        protection and priority."""
        d = self._index[path]
        worst = 0.0
        for a in d.ancestors():
            if a.high >= UNLIMITED or a.usage <= a.high:
                continue
            if a.protected:
                continue
            over = (a.usage - a.high) / max(a.high, 1)
            delay = min(max_delay_ms,
                        base_delay_ms * (1.0 + OVERAGE_GAIN * over))
            worst = max(worst, delay)
        if worst and d.priority == HIGH:
            worst *= HIGH_PRIORITY_DISCOUNT   # latency-sensitive domains barely stall
        if worst:
            d.n_throttle += 1
            self.log.emit(self.now_ms, Ev.THROTTLE, path, delay_ms=worst)
        return worst
