"""Frozen copy of the agent-trace generator and of the session mapping.

``generate_task`` is a copy of ``repro_torch/traces/generator.py::
generate_task`` (the paper's section-3 calibration of tool-call bursts),
and ``session_phases`` of the phase mapping of
``repro_torch/serving/session.py::session_from_trace``, as the port had
them when the benchmark was defined.  The benchmark draws its traffic
from these copies, never from the program, so that a change to the
program cannot change the traffic it is measured with.
``portbench/tests/test_portbench_frozen.py`` holds each copy equal to the
program's function.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ToolCall:
    tool: str
    category: str
    t_start_s: float
    dur_s: float
    peak_mb: float
    retained_mb: float = 0.0
    retry_group: int = -1

    @property
    def t_end_s(self) -> float:
        return self.t_start_s + self.dur_s


@dataclass
class TaskTrace:
    task_id: str
    model: str
    duration_s: float
    init_s: float
    baseline_mb: float
    tool_calls: list
    mem_mb: np.ndarray
    cpu_pct: np.ndarray
    seed: int = 0


# --------------------------------------------------------- category params

# (mean_mb, sigma_of_log, p95_target_mb) per bash category and model
BURST_MB = {
    "haiku": {"test": (180.0, 0.85, 518.0), "pip": (90.0, 0.8, 233.0),
              "python": (60.0, 0.8, 200.0), "file": (4.5, 0.5, 10.0),
              "git": (13.5, 0.5, 30.0), "build": (250.0, 0.7, 600.0)},
    "glm": {"test": (90.0, 0.8, 234.0), "pip": (90.0, 0.8, 233.0),
            "python": (80.0, 0.8, 250.0), "file": (4.5, 0.5, 10.0),
            "git": (13.5, 0.5, 30.0), "build": (250.0, 0.7, 600.0)},
    # a third burst-shape class between the two measured ones: bash-heavy
    # like GLM but with Haiku-class test bursts — lets the benchmarks
    # compare one policy across trace classes, not just across policies
    "qwen": {"test": (130.0, 0.9, 400.0), "pip": (90.0, 0.8, 233.0),
             "python": (70.0, 0.8, 220.0), "file": (4.5, 0.5, 10.0),
             "git": (13.5, 0.5, 30.0), "build": (250.0, 0.7, 600.0)},
}

# share of bash *time* per category
BASH_TIME_SHARE = {
    "haiku": {"test": 0.729, "pip": 0.10, "python": 0.05, "file": 0.06,
              "git": 0.04, "build": 0.021},
    "glm": {"test": 0.437, "pip": 0.10, "python": 0.269, "file": 0.10,
            "git": 0.074, "build": 0.02},
    "qwen": {"test": 0.58, "pip": 0.12, "python": 0.17, "file": 0.08,
             "git": 0.04, "build": 0.01},
}

# share of total tool time per tool
TOOL_TIME_SHARE = {
    "haiku": {"Bash": 0.478, "SubAgent": 0.432, "Read": 0.04, "Edit": 0.03,
              "Write": 0.01, "WebSearch": 0.01},
    "glm": {"Bash": 0.981, "Read": 0.01, "Edit": 0.007, "Write": 0.002},
    "qwen": {"Bash": 0.86, "SubAgent": 0.06, "Read": 0.04, "Edit": 0.03,
             "Write": 0.01},
}

DURATION_MEAN_S = {"haiku": 5.8 * 60, "glm": 10.8 * 60, "qwen": 7.5 * 60}
BASELINE_MB = {"haiku": 183.0, "glm": 188.0, "qwen": 176.0}
RETRY_TASK_FRAC = {"haiku": 0.85, "glm": 0.97, "qwen": 0.92}
RETRY_GROUPS_MEAN = {"haiku": 1.8, "glm": 3.9, "qwen": 2.8}
# % of one core outside calls / mean % during tool calls
CPU_IDLE = {"haiku": 8.0, "glm": 4.0, "qwen": 6.0}
CPU_BURST = {"haiku": 120.0, "glm": 90.0, "qwen": 105.0}


def _lognormal(rng, mean, sigma):
    """Lognormal with the given *mean* and log-space sigma."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    return float(rng.lognormal(mu, sigma))


def _task_scale(rng) -> float:
    """Per-task memory-appetite multiplier: the 20x cross-task spread.
    Heavy-tailed so a few tasks are pydicom-like (multi-GB)."""
    return float(np.exp(rng.normal(0.0, 0.9)))


def generate_task(task_id: str, model: str, seed: int, *,
                  scale: Optional[float] = None,
                  duration_s: Optional[float] = None,
                  peak_override_mb: Optional[float] = None,
                  sustain_frac: float = 0.0) -> TaskTrace:
    rng = np.random.default_rng(seed)
    model = model.lower()
    baseline = float(rng.normal(BASELINE_MB[model], 12.0))
    dur = duration_s if duration_s is not None else float(np.clip(
        _lognormal(rng, DURATION_MEAN_S[model], 0.25), 120, 1500))
    init_frac = float(rng.uniform(0.31, 0.48))
    init_s = dur * init_frac / (1 - init_frac)
    scale = scale if scale is not None else _task_scale(rng)

    # --- schedule tool calls until the tool-time budget is consumed
    tool_budget = dur * float(rng.uniform(0.30, 0.46))
    calls: list[ToolCall] = []
    t_share = TOOL_TIME_SHARE[model]
    b_share = BASH_TIME_SHARE[model]
    budgets = {tool: tool_budget * fr for tool, fr in t_share.items()}

    retry_target = (int(rng.poisson(RETRY_GROUPS_MEAN[model]))
                    if rng.random() < RETRY_TASK_FRAC[model] else 0)
    retry_target = max(retry_target, 1) if retry_target else 0
    group_id = 0

    def burst_for(cat: str) -> float:
        mean, sig, _ = BURST_MB[model][cat]
        return _lognormal(rng, mean * scale, sig)

    def sample_start(frac_lo, frac_hi):
        return float(rng.uniform(frac_lo, frac_hi)) * dur

    pending: list[ToolCall] = []
    for tool, budget in budgets.items():
        used = 0.0
        while used < budget:
            if tool == "Bash":
                cat = rng.choice(list(b_share), p=np.array(
                    list(b_share.values())) / sum(b_share.values()))
                d = float(np.clip(_lognormal(rng, 5.0, 1.0), 0.3, 120.0))
                # bash concentrates in 40-80 % of progress
                t0 = sample_start(0.25, 0.95)
                peak = burst_for(cat)
                if cat == "test" and retry_target and group_id < retry_target:
                    # retry loop: >=3 consecutive same-command calls with
                    # progressive accumulation (total retained capped at
                    # the paper's worst case ~502 MB per task)
                    n_retry = int(rng.integers(3, 9))
                    leak_budget = 502.0 / max(retry_target, 1)
                    leak_total = float(min(rng.uniform(30, 160) * scale,
                                           leak_budget))
                    leak = leak_total / n_retry
                    tt = t0
                    for _ in range(n_retry):
                        dd = float(np.clip(d * rng.uniform(0.7, 1.3), 0.3, 120))
                        pending.append(ToolCall("Bash", "test", tt, dd,
                                                peak_mb=peak * rng.uniform(0.8, 1.2),
                                                retained_mb=leak,
                                                retry_group=group_id))
                        used += dd
                        tt += dd + float(rng.uniform(0.5, 4.0))
                    group_id += 1
                    continue
                pending.append(ToolCall("Bash", cat, t0, d, peak_mb=peak))
                used += d
            elif tool == "SubAgent":
                d = float(np.clip(_lognormal(rng, 100.0, 0.5), 20, 300))
                pending.append(ToolCall("SubAgent", "subagent",
                                        sample_start(0.3, 0.8), d,
                                        peak_mb=burst_for("test") * 0.8))
                used += d
            elif tool in ("Read",):
                d = float(np.clip(rng.exponential(0.3), 0.05, 0.5))
                pending.append(ToolCall("Read", "read",
                                        sample_start(0.0, 0.35), d,
                                        peak_mb=float(rng.uniform(1, 6))))
                used += d
            elif tool in ("Edit", "Write"):
                d = float(np.clip(rng.exponential(0.3), 0.05, 0.5))
                pending.append(ToolCall(tool, "edit",
                                        sample_start(0.0, 1.0), d,
                                        peak_mb=float(rng.uniform(1, 8))))
                used += d
            else:  # WebSearch
                d = float(np.clip(rng.exponential(2.0), 0.5, 10.0))
                pending.append(ToolCall(tool, "web",
                                        sample_start(0.1, 0.9), d,
                                        peak_mb=float(rng.uniform(5, 30))))
                used += d

    # de-overlap: sort by start, push overlapping calls later (agent loop
    # is sequential — one tool call at a time)
    pending.sort(key=lambda c: c.t_start_s)
    t_cursor = 0.0
    for c in pending:
        c.t_start_s = max(c.t_start_s, t_cursor)
        t_cursor = c.t_start_s + c.dur_s
    dur = max(dur, t_cursor + 5.0)
    calls = pending

    # --- render 1-second samples
    T = int(math.ceil(dur)) + 1
    mem = np.full(T, baseline, np.float64)
    cpu = np.full(T, CPU_IDLE[model], np.float64)
    mem += rng.normal(0, 3.0, T)
    cpu += np.abs(rng.normal(0, 2.0, T))
    retained = 0.0
    for c in calls:
        i0, i1 = int(c.t_start_s), min(int(c.t_end_s) + 1, T)
        if i0 >= T:
            continue
        rise = max(1, min(2, i1 - i0))            # 1-2 s rise (>=1 GB/s poss.)
        for j in range(i0, i1):
            frac = min(1.0, (j - i0 + 1) / rise)
            mem[j] = max(mem[j], baseline + retained + c.peak_mb * frac)
            # CPU bursts are SPIKES at call start (paper: avg CPU stays
            # <13% of one core; peaks >100% are brief)
            if j - i0 < 2:
                cpu[j] = max(cpu[j], float(
                    rng.normal(CPU_BURST[model], 30.0)))
        retained += c.retained_mb
        if i1 < T:
            mem[i1:] += c.retained_mb              # progressive accumulation
    if sustain_frac > 0.0:
        # progressive-accumulation plateau (paper Fig 5/6: memory builds
        # through retry loops and stays elevated through the second half)
        peak_now = float(mem.max())
        floor = np.full(T, baseline)
        ramp_end = int(0.45 * T)
        hold_end = int(0.95 * T)
        tgt = baseline + sustain_frac * (peak_now - baseline)
        floor[:ramp_end] = np.linspace(baseline, tgt, ramp_end)
        floor[ramp_end:hold_end] = tgt
        floor[hold_end:] = np.linspace(tgt, baseline, T - hold_end)
        mem = np.maximum(mem, floor)

    np.clip(cpu, 0.5, 2400.0, out=cpu)
    np.clip(mem, 30.0, None, out=mem)

    if peak_override_mb is not None:
        # rescale the burst component so the trace peak matches the
        # paper's measured peak for this named task
        cur_peak = float(mem.max())
        if cur_peak > baseline + 1.0:
            k = (peak_override_mb - baseline) / (cur_peak - baseline)
            mem = baseline + (mem - baseline) * k
            for c in calls:
                c.peak_mb *= k
                c.retained_mb *= k

    return TaskTrace(task_id=task_id, model=model, duration_s=float(dur),
                     init_s=float(init_s), baseline_mb=baseline,
                     tool_calls=calls, mem_mb=mem, cpu_pct=cpu, seed=seed)


def session_phases(trace: TaskTrace, *, tokens_per_mb: float,
                   gen_per_call: int, max_phases: int) -> list:
    """The phases ``session_from_trace`` derives from a trace, as
    ``(gen_tokens, append_tokens, category)``: each tool call in start
    order becomes a phase whose appended result scales with its burst."""
    return [(gen_per_call, max(4, int(c.peak_mb * tokens_per_mb)),
             c.category)
            for c in sorted(trace.tool_calls,
                            key=lambda c: c.t_start_s)[:max_phases]]
