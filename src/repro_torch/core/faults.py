"""Deterministic fault injection for the control plane.

Port of ``repro/core/faults.py``: the same seeded schedule, so a plan's
JSON written by either package injects the same faults at the same ops
in the other.  ``FaultyBackend`` wraps any ``Backend`` (host, device,
sharded, and, composed inside ``AsyncDaemonBackend``, the async kinds)
and injects faults from a seeded ``FaultPlan``:

  * transient op errors: ``TransientBackendError`` raised *before* the
    inner op applies, so a retry is always safe;
  * delayed applies: the op sleeps before applying (off the critical
    path on async backends, visible latency on sync ones);
  * spurious memcg kills: an out-of-band ``kill`` on a live domain, the
    "kernel OOM-killed the tool" case escalation must absorb;
  * daemon wedges: the op blocks until ``unwedge()`` (or the wedge
    timeout); inside an ``AsyncDaemonBackend`` this wedges the daemon
    thread, so ``flush`` times out and poisons the backend, the failure
    the engine's rebuild path recovers from;
  * kills mid-freeze: the kernel OOM killer fires while the freezer is
    quiescing the subtree: the domain is killed first, then the freeze
    applies to the dead subtree (``p_kill_mid_freeze``);
  * offload transients: the device->host state offload fails partway
    (``p_offload_transient``): ``offload_fault`` plugs into
    ``FrozenStore.offload_hook``, which raises BEFORE the entry
    commits, never leaving a partial frozen entry, so a retry is safe.

All randomness comes from one ``numpy`` generator seeded by the plan and
advanced a fixed four draws per intercepted op, so a given plan and op
sequence always inject the same faults: every chaos failure replays from
the plan alone.  The freeze/offload chaos points draw from a SEPARATE
stream (seeded ``seed ^ _CHAOS_SEED``, one draw per event, only when
their probability is nonzero) so enabling them never shifts the
four-draw schedule of an existing plan.

With the default (fault-free) plan the wrapper is bit-exact with its
inner backend, which ``testing.conformance.faulty_backend_factory``
certifies for all six backend kinds.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

# lifecycle/mutating ops eligible for fault injection (reads stay
# clean so observation never perturbs the run)
MUTATING_OPS = ("mkdir", "rmdir", "write", "try_charge", "uncharge",
                "charge_unchecked", "freeze", "thaw", "kill",
                "attach", "update_params", "schedule")


class TransientBackendError(RuntimeError):
    """Injected transient failure: the op did NOT apply; retrying it is
    safe (and, with ``auto_retry``, automatic)."""


# XOR'd into the plan seed for the freeze/offload chaos stream, so the
# new fault points never advance the original four-draw-per-op schedule
_CHAOS_SEED = 0x5EED


@dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule.  The default plan injects nothing."""
    seed: int = 0
    p_transient: float = 0.0
    p_delay: float = 0.0
    delay_s: float = 0.001
    p_spurious_kill: float = 0.0
    p_wedge: float = 0.0
    wedge_s: float = 5.0
    # freeze/offload chaos (separate RNG stream; see module docstring)
    p_kill_mid_freeze: float = 0.0
    p_offload_transient: float = 0.0
    ops: tuple = MUTATING_OPS

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ops"] = list(d["ops"])
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        d["ops"] = tuple(d["ops"])
        return cls(**d)


class FaultyBackend:
    """Transparent fault-injecting wrapper around any backend.

    ``auto_retry`` > 0 makes injected transients self-heal (the op
    applies after the retries the caller would have issued) — with it,
    a transient-only plan stays bit-exact with the fault-free run.
    ``on_spurious_kill(path, freed)`` lets a harness route an injected
    kill into the intent channel (``note_external_kill``); it MUST NOT
    call back into an async facade when this wrapper runs inside an
    ``AsyncDaemonBackend`` (it would flush from the daemon thread).
    """

    def __init__(self, inner, plan: Optional[FaultPlan] = None, *,
                 auto_retry: int = 0,
                 on_spurious_kill: Optional[Callable] = None):
        self._inner = inner
        self.plan = plan if plan is not None else FaultPlan()
        self.auto_retry = auto_retry
        self.on_spurious_kill = on_spurious_kill
        self._rng = np.random.default_rng(self.plan.seed)
        self._chaos_rng = np.random.default_rng(self.plan.seed ^ _CHAOS_SEED)
        self._op_no = 0
        self._unwedge = threading.Event()
        self.injected: list[tuple] = []   # (op_no, op, fault, detail)

    # ------------------------------------------------------------ injection

    def unwedge(self) -> None:
        """Release any current (and future) wedge."""
        self._unwedge.set()

    def _pre_fault(self, name: str) -> bool:
        """Draws this op's fault decisions; returns True when a
        transient error should fire.  Fixed four draws per op keeps the
        schedule independent of fault outcomes."""
        p = self.plan
        r_tr, r_dl, r_ki, r_we = self._rng.random(4)
        op_no = self._op_no
        self._op_no += 1
        if r_we < p.p_wedge:
            self.injected.append((op_no, name, "wedge", p.wedge_s))
            self._unwedge.wait(p.wedge_s)
        if r_dl < p.p_delay:
            self.injected.append((op_no, name, "delay", p.delay_s))
            time.sleep(p.delay_s)
        if r_ki < p.p_spurious_kill:
            self._spurious_kill(op_no)
        return r_tr < p.p_transient

    def _spurious_kill(self, op_no: int) -> None:
        victims = sorted(p for p in self._inner.paths()
                         if p != "/" and len(p.split("/")) > 2)
        if not victims:
            return
        pick = victims[int(self._rng.integers(len(victims)))]
        freed = self._inner.kill(pick)
        self.injected.append((op_no, "kill", "spurious_kill", pick))
        if self.on_spurious_kill is not None:
            self.on_spurious_kill(pick, freed)

    def _kill_mid_freeze(self, path: str) -> None:
        """The kernel OOM killer fired while the freezer was quiescing:
        the subtree dies FIRST (usage released, domains retired), then
        the caller's freeze applies to the dead subtree — the race the
        escalation/engine recovery paths must absorb."""
        freed = self._inner.kill(path)
        self.injected.append((self._op_no - 1, "freeze",
                              "kill_mid_freeze", path))
        if self.on_spurious_kill is not None:
            self.on_spurious_kill(path, freed)

    def offload_fault(self, session_id: str) -> None:
        """``FrozenStore.offload_hook`` seam: wire as
        ``caches.store.offload_hook = faulty.offload_fault`` and the
        device->host offload fails transiently mid-copy — the hook
        raises before the entry commits, so the store never holds a
        partial entry and the caller's retry is safe."""
        if self.plan.p_offload_transient <= 0.0:
            return
        if self._chaos_rng.random() < self.plan.p_offload_transient:
            self.injected.append((self._op_no, "offload", "transient",
                                  session_id))
            raise TransientBackendError(
                f"injected offload failure for {session_id!r} "
                f"(seed {self.plan.seed})")

    def _wrap(self, name: str, fn):
        def wrapper(*a, **k):
            transient = self._pre_fault(name)
            if transient:
                self.injected.append((self._op_no - 1, name, "transient", ""))
                if self.auto_retry <= 0:
                    raise TransientBackendError(
                        f"injected transient failure in {name} "
                        f"(op #{self._op_no - 1}, seed {self.plan.seed})")
            if (name == "freeze" and self.plan.p_kill_mid_freeze > 0.0
                    and self._chaos_rng.random()
                    < self.plan.p_kill_mid_freeze):
                self._kill_mid_freeze(a[0] if a else k["path"])
            return fn(*a, **k)
        return wrapper

    # ---------------------------------------------------------- passthrough

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self.plan.ops and callable(attr):
            return self._wrap(name, attr)
        return attr

    def close(self, **kw) -> None:
        self.unwedge()
        fn = getattr(self._inner, "close", None)
        if fn is not None:
            fn(**kw)
