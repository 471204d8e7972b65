"""PSI-style pressure accounting (the /proc/pressure analogue).

The paper's third mismatch is adaptability: history-based prediction
cannot size limits for non-deterministic agent executions, so the
control plane must *observe* contention and react.  Linux exposes
contention as PSI (pressure stall information): per-cgroup files
``memory.pressure`` / ``cpu.pressure`` reporting the fraction of
recent time some task was stalled on that resource, as ``avg10`` /
``avg60`` exponentially-weighted averages.

The in-repo analogue splits the work exactly like the weight
flattening in ``core/sched.py``:

  * **In-step accounting** — two i32 control-state rows, ``mem_stall``
    and ``cpu_stall``, count stall *events* per domain: a charge
    decision that stalled or throttled (``charge_stall_event``, called
    from every ``charge_decision`` caller) and a valid schedule slot
    that did not advance (``sched_stall_events``, called inside
    ``schedule_decision``).  Plain torch on tensors; the CUDA charge
    kernel (``csrc/enforcement.cu``) applies the same saturating rule.
  * **Host-side aggregation** — like ``flat_weights_by_path``, the
    hierarchy roll-up is pure host math over the logical path tree
    (``subtree_counts_by_path``): a domain's pressure includes every
    descendant, computed at read rate, never inside the step.
  * **Host-side averaging** — ``PressureMeter`` turns monotone counter
    reads into PSI-style ``some avg10/avg60`` lines.  Decay runs on
    the facade clock (``AgentCgroup.set_time``) quantized by the
    program's ``step_ms`` — never wall time, so replay is
    deterministic and two backends fed the same ops render identical
    pressure strings.

Port of ``repro/core/pressure.py``.  This module is a decision module
for tracelint purposes: the traced helpers admit no host syncs and no
suppression pragmas.
"""
from __future__ import annotations

import math

import torch

# PSI windows, on the facade ms clock (10 s / 60 s like /proc/pressure)
AVG10_MS = 10_000.0
AVG60_MS = 60_000.0

PRESSURE_FILES = ("memory.pressure", "cpu.pressure")
# raw monotone counters backing the pressure files (subtree-aggregated
# stall-event counts; the facade's PressureMeter averages them)
STALL_FILES = ("memory.stall", "cpu.stall")

STALL_OF = {"memory.pressure": "memory.stall", "cpu.pressure": "cpu.stall"}

# Saturation ceiling for the stall accumulators.  The counters are i32
# control-state rows (x64 is off); a long-lived engine accumulating one
# event per step would wrap negative after ~2^31 events and corrupt the
# PSI averages (the meter clamps negative deltas to 0, so a wrapped
# counter reads as permanent calm).  Every accumulation site — traced
# and host-side — saturates here instead.
INT32_MAX = 2**31 - 1


def saturating_count(counter, events):
    """Accumulate stall ``events`` into an i32 ``counter`` saturating at
    ``INT32_MAX`` instead of wrapping negative.  Elementwise, so it
    composes with one slot's update and whole-row updates alike; the
    wrapped sum in the untaken branch is computed but always
    discarded, as in the reference."""
    counter = torch.as_tensor(counter, dtype=torch.int32)
    inc = torch.as_tensor(events, dtype=torch.int32, device=counter.device)
    return torch.where(inc > INT32_MAX - counter,
                       torch.full_like(counter, INT32_MAX), counter + inc)


def charge_stall_event(stalled, throttled):
    """1 iff this charge decision counts as a memory-stall event: the
    request stalled (denied by freeze/throttle/max) or was granted
    under a graduated throttle."""
    return torch.logical_or(stalled, throttled).to(torch.int32)


def sched_stall_events(dom, advance):
    """Per-slot i32 CPU-stall indicators for one scheduling round: a
    valid slot (``dom >= 0``) that may not advance — gated, quota-
    capped, or beaten in the budget race — stalls its domain."""
    return torch.logical_and(dom >= 0,
                             torch.logical_not(advance)).to(torch.int32)


def subtree_counts_by_path(counts: dict) -> dict:
    """Hierarchical roll-up of per-domain stall counters: ``total(d) =
    own(d) + sum(total(children))`` over the logical path tree.

    ``counts`` maps every live path to its own (local) counter.  Pure
    integer host math — like ``flat_weights_by_path``, every backend
    (including the sharded one, whose per-shard tables only see a
    slice of the tree) aggregates identically.
    """
    kids: dict = {}
    for p in counts:
        if p != "/":
            kids.setdefault(p.rsplit("/", 1)[0] or "/", []).append(p)
    total = dict(counts)

    def walk(path):
        for c in kids.get(path, ()):
            walk(c)
            total[path] += total[c]

    if "/" in total:
        walk("/")
    else:                       # partial view (no root row): roots are
        for p in counts:        # the paths whose parent is absent
            parent = p.rsplit("/", 1)[0] or "/"
            if parent not in counts:
                walk(p)
    return total


def format_psi(avg10: float, avg60: float, total: int) -> str:
    """Render one PSI line: ``some avg10=<pct> avg60=<pct> total=<n>``
    (percent of recent steps stalled; ``total`` is the raw aggregated
    stall-event count, the analogue of PSI's total stall time)."""
    return (f"some avg10={avg10 * 100.0:.2f} "
            f"avg60={avg60 * 100.0:.2f} total={int(total)}")


class PressureMeter:
    """Counter-to-average converter for the pressure control files.

    One meter per facade; per (path, file) it tracks the last sampled
    (clock, counter) pair and the two running averages.  A sample at
    clock ``now`` converts the counter delta into a stall *fraction*
    (events per elapsed step, clamped to [0, 1] — the PSI "some share
    of time" analogue) and folds it into each window with the exact
    decay ``exp(-dt / window)``.  All inputs come off the facade clock
    and the device counters, so identical op sequences yield identical
    strings on every backend.
    """

    def __init__(self, step_ms: float = 10.0,
                 windows: tuple = (AVG10_MS, AVG60_MS)):
        # ``step_ms`` is the step quantum in facade-clock units and
        # ``windows`` the two decay windows in the same units.  A
        # facade whose clock counts ms keeps the defaults (and tracks
        # the attached program's step_ms — ``auto_step``); a caller
        # whose clock counts steps (the serving engine) reconfigures
        # via ``AgentCgroup.pressure_clock``.
        self.step_ms = float(step_ms)
        self.windows = (float(windows[0]), float(windows[1]))
        self.auto_step = True
        self._rows: dict = {}    # (path, file) -> [t, count, avg10, avg60]

    def sample(self, path: str, file: str, total: int, now: float):
        row = self._rows.get((path, file))
        if row is None:
            row = [float(now), int(total), 0.0, 0.0]
            self._rows[(path, file)] = row
            return row
        dt = float(now) - row[0]
        if dt <= 0.0:
            return row
        steps = max(dt / self.step_ms, 1.0)
        frac = min(max(int(total) - row[1], 0) / steps, 1.0)
        for slot, window in ((2, self.windows[0]), (3, self.windows[1])):
            a = math.exp(-dt / window)
            row[slot] = row[slot] * a + frac * (1.0 - a)
        row[0], row[1] = float(now), int(total)
        return row

    def read(self, path: str, file: str, total: int, now: float) -> str:
        row = self.sample(path, file, total, now)
        return format_psi(row[2], row[3], total)

    def avg10(self, path: str, file: str) -> float:
        row = self._rows.get((path, file))
        return row[2] if row is not None else 0.0

    def forget(self, path: str) -> None:
        """Drop meter rows for a removed domain (and its subtree)."""
        for key in [k for k in self._rows
                    if k[0] == path or k[0].startswith(path + "/")]:
            del self._rows[key]


def parse_psi(line: str) -> dict:
    """Parse a PSI line back into ``{"avg10": frac, "avg60": frac,
    "total": int}`` (averages as [0, 1] fractions) — what the adaptive
    controller consumes, reading only the public file surface."""
    fields = dict(kv.split("=", 1) for kv in line.split()[1:])
    return {"avg10": float(fields["avg10"]) / 100.0,
            "avg60": float(fields["avg60"]) / 100.0,
            "total": int(fields["total"])}


class PressureMeter:
    """Counter-to-average converter for the pressure control files.

    One meter per facade; per (path, file) it tracks the last sampled
    (clock, counter) pair and the two running averages.  A sample at
    clock ``now`` converts the counter delta into a stall *fraction*
    (events per elapsed step, clamped to [0, 1] — the PSI "some share
    of time" analogue) and folds it into each window with the exact
    decay ``exp(-dt / window)``.  All inputs come off the facade clock
    and the device counters, so identical op sequences yield identical
    strings on every backend.
    """

    def __init__(self, step_ms: float = 10.0,
                 windows: tuple = (AVG10_MS, AVG60_MS)):
        # ``step_ms`` is the step quantum in facade-clock units and
        # ``windows`` the two decay windows in the same units.  A
        # facade whose clock counts ms keeps the defaults (and tracks
        # the attached program's step_ms — ``auto_step``); a caller
        # whose clock counts steps (the serving engine) reconfigures
        # via ``AgentCgroup.pressure_clock``.
        self.step_ms = float(step_ms)
        self.windows = (float(windows[0]), float(windows[1]))
        self.auto_step = True
        self._rows: dict = {}    # (path, file) -> [t, count, avg10, avg60]

    def sample(self, path: str, file: str, total: int, now: float):
        row = self._rows.get((path, file))
        if row is None:
            row = [float(now), int(total), 0.0, 0.0]
            self._rows[(path, file)] = row
            return row
        dt = float(now) - row[0]
        if dt <= 0.0:
            return row
        steps = max(dt / self.step_ms, 1.0)
        frac = min(max(int(total) - row[1], 0) / steps, 1.0)
        for slot, window in ((2, self.windows[0]), (3, self.windows[1])):
            a = math.exp(-dt / window)
            row[slot] = row[slot] * a + frac * (1.0 - a)
        row[0], row[1] = float(now), int(total)
        return row

    def read(self, path: str, file: str, total: int, now: float) -> str:
        row = self.sample(path, file, total, now)
        return format_psi(row[2], row[3], total)

    def avg10(self, path: str, file: str) -> float:
        row = self._rows.get((path, file))
        return row[2] if row is not None else 0.0

    def forget(self, path: str) -> None:
        """Drop meter rows for a removed domain (and its subtree)."""
        for key in [k for k in self._rows
                    if k[0] == path or k[0].startswith(path + "/")]:
            del self._rows[key]
