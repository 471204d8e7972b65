"""Closed-loop adaptive retuner driven by pressure (core/pressure.py).

The paper's third mismatch — static, history-sized limits vs
non-deterministic agent executions — calls for a controller that
*observes* contention and reacts, the way userspace PSI consumers
(oomd, senpai) sit on /proc/pressure.  ``AdaptiveController`` closes
that loop using only public surfaces and zero-retrace knobs:

  * it reads ``memory.pressure`` / ``cpu.pressure`` through the facade
    (``parse_psi``), never touching backend internals, so it works
    unmodified on all six backend kinds;
  * sustained memory pressure (``avg10`` above ``high_frac``) bumps
    the domain's soft limit — ``memory.high`` grows by ``bump_factor``
    but NEVER exceeds ``memory.max`` — the classic containers-style
    soft-limit controller move: relieve throttling without weakening
    the hard isolation wall;
  * sustained CPU pressure applies the configured parameter retunes
    (e.g. ``sched_boost``) via ``update_params`` — a pure device state
    write, no retrace;
  * when ``avg10`` falls back below ``low_frac`` the knob is restored,
    with hysteresis (the [low_frac, high_frac] dead band) and a
    per-domain ``cooldown_ms`` so the loop cannot oscillate
    step-to-step.

Every action is emitted as a typed ``PressureEvent`` (and an
``Ev.PRESSURE`` log record), so benchmarks and the conformance kit can
replay exactly what the retuner did and when.  All decisions run off
the caller-supplied clock (the facade / step clock) — never wall time
— keeping replay deterministic.

Port of ``repro/core/adaptive.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.domains import UNLIMITED
from repro_torch.core.events import Ev, PressureEvent
from repro_torch.core.pressure import parse_psi


@dataclass(frozen=True)
class AdaptiveConfig:
    """Retuner policy.  ``None`` at the engine level (the default)
    disables the loop entirely — behavior stays bit-identical."""
    high_frac: float = 0.15        # act when avg10 rises above this
    low_frac: float = 0.05         # restore when avg10 falls below this
    bump_factor: float = 1.5       # memory.high multiplier per bump
    max_bumps: int = 3             # bump ceiling per domain
    cooldown_ms: float = 200.0     # min clock between actions per domain
    # (param, pressured_value, calm_value) triples applied via
    # update_params on sustained CPU pressure and restored when calm —
    # calm values are declared, not read back, so no param introspection
    retune: tuple = ()
    # domains to watch; None = every child of "/" at poll time
    watch: Optional[tuple] = None


class AdaptiveController:
    """The closed loop: poll pressure, turn knobs, emit events.

    One instance per facade.  ``poll(now_ms)`` is cheap enough to run
    at step boundaries (host-driven lifecycles) or at the async
    daemon's epoch cadence; it returns the typed actions it took.
    """

    def __init__(self, cg, cfg: Optional[AdaptiveConfig] = None):
        self.cg = cg
        self.cfg = cfg or AdaptiveConfig()
        self.events: list[PressureEvent] = []
        self._bumps: dict = {}         # path -> (original_high, n_bumps)
        self._retuned: set = set()     # paths with pressured params live
        self._last: dict = {}          # (path, file) -> last action clock

    # ------------------------------------------------------------- helpers

    def _watched(self) -> list:
        if self.cfg.watch is not None:
            return [p for p in self.cfg.watch if self.cg.exists(p)]
        return [p for p in self.cg.paths()
                if p != "/" and "/" not in p.strip("/")]

    def _cooled(self, path: str, file: str, now: float) -> bool:
        last = self._last.get((path, file))
        return last is None or now - last >= self.cfg.cooldown_ms

    def _emit(self, now: float, path: str, file: str, avg10: float,
              action: str, old: float, new: float) -> PressureEvent:
        ev = PressureEvent(path=path, file=file, avg10=avg10,
                           action=action, old=old, new=new, t_ms=now)
        self.events.append(ev)
        self.cg.log.emit(now, Ev.PRESSURE, path, file=file,
                         avg10=round(avg10, 6), action=action,
                         old=old, new=new)
        self._last[(path, file)] = now
        return ev

    # ------------------------------------------------------------ the loop

    def poll(self, now_ms: float) -> list:
        out = []
        for path in self._watched():
            out.extend(self._poll_memory(path, now_ms))
            if self.cfg.retune:
                out.extend(self._poll_cpu(path, now_ms))
        return out

    def _poll_memory(self, path: str, now: float) -> list:
        cfg = self.cfg
        psi = parse_psi(self.cg.read(path, "memory.pressure"))
        avg10 = psi["avg10"]
        if avg10 >= cfg.high_frac:
            if not self._cooled(path, "memory.pressure", now):
                return []
            high = int(self.cg.read(path, "memory.high"))
            if high >= UNLIMITED:          # nothing to relieve
                return []
            orig, n = self._bumps.get(path, (high, 0))
            if n >= cfg.max_bumps:
                return []
            cap = int(self.cg.read(path, "memory.max"))
            new = min(int(high * cfg.bump_factor), cap)   # never past max
            if new <= high:
                return []
            self.cg.write(path, "memory.high", new)
            self._bumps[path] = (orig, n + 1)
            return [self._emit(now, path, "memory.pressure", avg10,
                               "bump_high", float(high), float(new))]
        if avg10 <= cfg.low_frac and path in self._bumps:
            if not self._cooled(path, "memory.pressure", now):
                return []
            orig, _ = self._bumps.pop(path)
            high = int(self.cg.read(path, "memory.high"))
            self.cg.write(path, "memory.high", orig)
            return [self._emit(now, path, "memory.pressure", avg10,
                               "restore_high", float(high), float(orig))]
        return []

    def _poll_cpu(self, path: str, now: float) -> list:
        cfg = self.cfg
        psi = parse_psi(self.cg.read(path, "cpu.pressure"))
        avg10 = psi["avg10"]
        if avg10 >= cfg.high_frac and path not in self._retuned:
            if not self._cooled(path, "cpu.pressure", now):
                return []
            self.cg.update_params(
                path, {k: v for k, v, _ in cfg.retune})
            self._retuned.add(path)
            k, v, old = cfg.retune[0]
            return [self._emit(now, path, "cpu.pressure", avg10,
                               "retune", float(old), float(v))]
        if avg10 <= cfg.low_frac and path in self._retuned:
            if not self._cooled(path, "cpu.pressure", now):
                return []
            self.cg.update_params(
                path, {k: calm for k, _, calm in cfg.retune})
            self._retuned.discard(path)
            k, v, calm = cfg.retune[0]
            return [self._emit(now, path, "cpu.pressure", avg10,
                               "restore_params", float(v), float(calm))]
        return []
