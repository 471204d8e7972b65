"""Spans and step-phase clocks inside the serving engine.

Three things, none of them part of the control state:

* ``span(name)``: a range the profiler sees.  With no profiler running
  it costs one test of a flag and returns a shared no-op context.  Under
  ``torch.profiler`` it opens ``torch._C._profiler._RecordFunctionFast``,
  a function-scope range: the host events then carry the program's own
  phases on the clock of the device events, and a gap in the device's
  work is named by the phase the host was in.  Never a user-scope range
  (``torch.profiler.record_function``): under CUDA each of those also
  becomes a ``gpu_user_annotation`` event on the device's side of the
  trace, from the first to the last kernel it launched, which a reader
  of the device trace would count as busy time.
* The step clock, always on, like cgroup's ``memory.stat``: each
  ``Engine.step`` writes one row of ``STEP_COLUMNS`` into a ring of
  ``STEP_CAPACITY`` steps: the engine's id, its ``step_no``, start and
  end on ``time.perf_counter_ns()``, the nanoseconds of each phase of
  ``PHASES``, which tile the step, ``graphed``: 1 where the step's
  device work was issued as one CUDA graph's replay, else 0, and an MoE
  model's ``moe_assigned`` (the routed assignments the held experts
  received over the step's MoE layers) and ``moe_rows`` (the
  expert-product rows its dispatch computed), counted on the device
  inside the step; 0 and 0 without MoE layers.
* Admission records: ``Engine.submit`` stamps a session's submission,
  ``Engine._try_admit`` its admission (``admit_ns`` is -1 while it
  waits), with its priority, in a ring of ``SESSION_CAPACITY``.

Readers: ``steps()`` and ``sessions()`` give each column as a numpy
array, oldest row first; ``reset()`` clears both rings.  The clock is
``perf_counter``'s, so a caller that timed a window with
``time.perf_counter()`` keeps the rows whose times lie inside it.  The
rings are the process's, as a kernel's counters are; every engine in the
process writes to them from the thread that steps it, and its id tells
its rows apart.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

# the step's top-level phases, in order (each a span ``engine.<phase>``)
PHASES = ("flush", "policy", "inputs", "issue", "readback", "sessions",
          "daemon")
STEP_COLUMNS = ("engine", "step", "start_ns", "end_ns") + PHASES + (
    "graphed", "moe_assigned", "moe_rows")
SESSION_COLUMNS = ("engine", "priority", "submit_ns", "admit_ns")
STEP_CAPACITY = 8192
SESSION_CAPACITY = 8192


class _Off:
    """The span with no profiler running: enters and leaves, doing
    nothing (a plain class: ``contextlib.nullcontext`` costs twice as
    much a site)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A range named ``name`` under a running profiler, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class _Ring:
    """A fixed number of int64 rows, the oldest overwritten first."""

    def __init__(self, columns: tuple, capacity: int):
        self.columns = columns
        self._rows = np.zeros((capacity, len(columns)), np.int64)
        self.n = 0                    # rows ever written
        self.first = 0                # the first row since the last clear

    def _live(self) -> int:
        return max(self.first, self.n - len(self._rows))

    def append(self, row) -> int:
        """Write ``row``; its index among all rows ever written."""
        i = self.n
        self._rows[i % len(self._rows)] = row
        self.n = i + 1
        return i

    def put(self, i: int, column: int, value: int) -> None:
        """Set one value of row ``i``, unless it has been overwritten or
        cleared."""
        if i >= self._live():
            self._rows[i % len(self._rows), column] = value

    def clear(self) -> None:
        self.first = self.n

    def read(self) -> dict:
        rows = self._rows[np.arange(self._live(), self.n) % len(self._rows)]
        return {c: rows[:, j] for j, c in enumerate(self.columns)}


_steps = _Ring(STEP_COLUMNS, STEP_CAPACITY)
_sessions = _Ring(SESSION_COLUMNS, SESSION_CAPACITY)
_engine_ids = itertools.count(1)
_ADMIT = SESSION_COLUMNS.index("admit_ns")


def engine_id() -> int:
    """A new id for an engine's rows."""
    return next(_engine_ids)


def record_step(engine: int, step: int, marks: list, graphed: int,
                moe=()) -> None:
    """One step's row from its ``len(PHASES) + 1`` boundaries (ns),
    whether its device work was a graph's replay (1) or not (0) and its
    MoE counts ``(assigned, rows)`` (none: 0, 0)."""
    _steps.append([engine, step, marks[0], marks[-1]]
                  + [b - a for a, b in zip(marks, marks[1:])] + [graphed]
                  + (list(moe) or [0, 0]))


def record_submit(engine: int, priority: int, t_ns: int) -> int:
    """A session submitted at ``t_ns``; the row's index for its
    admission."""
    return _sessions.append((engine, priority, t_ns, -1))


def record_admit(row: int, t_ns: int) -> None:
    _sessions.put(row, _ADMIT, t_ns)


def steps() -> dict:
    """The step rows, a numpy array a column of ``STEP_COLUMNS``."""
    return _steps.read()


def sessions() -> dict:
    """The admission rows, a numpy array a column of ``SESSION_COLUMNS``."""
    return _sessions.read()


def reset() -> None:
    _steps.clear()
    _sessions.clear()
