"""Agent-workload trace schema.

A ``TaskTrace`` mirrors what the paper measured per SWE-rebench task:
1-second CPU/memory samples plus per-tool-call spans with semantic
categories.  Traces are either synthesized by ``generator.py``
(calibrated to the paper's §3 statistics) or hand-built in tests.

Port of ``repro/traces/schema.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

TOOLS = ("Bash", "Read", "Edit", "Write", "SubAgent", "WebSearch")
BASH_CATEGORIES = ("test", "pip", "python", "file", "git", "build")


@dataclass
class ToolCall:
    tool: str                    # one of TOOLS
    category: str                # semantic category ("test", "git", ...)
    t_start_s: float             # seconds from task start
    dur_s: float
    peak_mb: float               # peak incremental memory of the call
    retained_mb: float = 0.0     # memory NOT released on exit (retry leak)
    retry_group: int = -1        # >=0: index of the retry loop it belongs to

    @property
    def t_end_s(self) -> float:
        return self.t_start_s + self.dur_s


@dataclass
class TaskTrace:
    task_id: str
    model: str                   # "haiku" | "glm"
    duration_s: float            # active (post-init) duration
    init_s: float                # container + agent initialization
    baseline_mb: float
    tool_calls: list             # list[ToolCall], sorted by t_start_s
    mem_mb: np.ndarray           # (T,) 1-second samples, active phase
    cpu_pct: np.ndarray          # (T,) 1-second samples (100 = one core)
    seed: int = 0

    @property
    def total_s(self) -> float:
        return self.init_s + self.duration_s

    @property
    def peak_mb(self) -> float:
        return float(self.mem_mb.max())

    @property
    def avg_mb(self) -> float:
        return float(self.mem_mb.mean())

    @property
    def peak_to_avg(self) -> float:
        return self.peak_mb / max(self.avg_mb, 1e-9)

    def tool_time_s(self) -> float:
        return sum(c.dur_s for c in self.tool_calls)

    def in_tool_call(self, t_s: float) -> bool:
        return any(c.t_start_s <= t_s < c.t_end_s for c in self.tool_calls)

    def retry_groups(self) -> dict[int, list]:
        out: dict[int, list] = {}
        for c in self.tool_calls:
            if c.retry_group >= 0:
                out.setdefault(c.retry_group, []).append(c)
        return {g: cs for g, cs in out.items() if len(cs) >= 3}


@dataclass
class AllocEvent:
    """Replay-level event: signed memory delta at a simulated time."""
    t_ms: float
    delta_mb: float
    tool: Optional[ToolCall] = None     # None = framework-baseline delta


def to_alloc_events(trace: TaskTrace, *, accel: float = 50.0,
                    sample_s: float = 1.0) -> list[AllocEvent]:
    """Convert 1-second memory samples to allocation/release deltas,
    replayed at ``accel``x speed (paper §6 replays at 50x)."""
    import numpy as np
    events = []
    ms_per_sample = sample_s * 1000.0 / accel
    # integerize the PROFILE (not the deltas): per-event rounding would
    # random-walk usage away from the trace by tens of MB
    mem_int = np.rint(np.asarray(trace.mem_mb)).astype(np.int64)
    prev = 0
    calls = sorted(trace.tool_calls, key=lambda c: c.t_start_s)
    for i, m in enumerate(mem_int):
        t_s = i * sample_s
        delta = int(m) - prev
        if delta != 0:
            tool = next((c for c in calls
                         if c.t_start_s <= t_s < c.t_end_s), None)
            events.append(AllocEvent(i * ms_per_sample, float(delta), tool))
        prev = int(m)
    # final release of everything at end
    if prev > 0:
        events.append(AllocEvent(len(mem_int) * ms_per_sample,
                                 float(-prev), None))
    return events
