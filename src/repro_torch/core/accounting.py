"""PSI-style pressure accounting + allocation-latency histograms.

The paper's responsiveness analysis (§4.2) hinges on *when* a pressure
signal becomes actionable: PSI aggregates stalls over 2s/10s windows and
a user-space daemon adds tens of ms of reaction latency, while agent
bursts live 1-2 s.  This module provides both the PSI-window view (for
the reactive baseline policy) and exact per-allocation latency records
(for the Fig-8 P50/P95 metrics).

Port of ``repro/core/accounting.py`` (pure Python; it imports nothing of
the JAX package).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Optional


class PSITracker:
    """Sliding-window 'some' pressure: fraction of wall time in which at
    least one allocation in the domain was stalled."""

    def __init__(self, window_ms: float = 2000.0):
        self.window_ms = window_ms
        self._stalls: list[tuple[float, float]] = []   # (start, end)

    def record_stall(self, start_ms: float, duration_ms: float) -> None:
        if duration_ms > 0:
            self._stalls.append((start_ms, start_ms + duration_ms))

    def pressure(self, now_ms: float) -> float:
        lo = now_ms - self.window_ms
        total = 0.0
        for s, e in self._stalls:
            total += max(0.0, min(e, now_ms) - max(s, lo))
        return min(1.0, total / self.window_ms)

    def gc(self, now_ms: float) -> None:
        lo = now_ms - self.window_ms
        self._stalls = [(s, e) for s, e in self._stalls if e > lo]


@dataclass
class LatencyStats:
    samples: list = field(default_factory=list)

    def add(self, ms: float) -> None:
        self.samples.append(ms)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        k = (len(xs) - 1) * p / 100.0
        f = math.floor(k)
        c = min(f + 1, len(xs) - 1)
        if f == c:
            return xs[int(k)]
        return xs[f] * (c - k) + xs[c] * (k - f)

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def n(self) -> int:
        return len(self.samples)


class Accounting:
    """Per-domain-prefix accounting bundle used by the replay harness."""

    def __init__(self, psi_window_ms: float = 2000.0):
        self.psi: dict[str, PSITracker] = {}
        self.alloc_latency: dict[str, LatencyStats] = {}
        self.psi_window_ms = psi_window_ms

    def _psi(self, key: str) -> PSITracker:
        if key not in self.psi:
            self.psi[key] = PSITracker(self.psi_window_ms)
        return self.psi[key]

    def _lat(self, key: str) -> LatencyStats:
        if key not in self.alloc_latency:
            self.alloc_latency[key] = LatencyStats()
        return self.alloc_latency[key]

    def record_alloc(self, key: str, t_ms: float, latency_ms: float) -> None:
        self._lat(key).add(latency_ms)
        if latency_ms > 0:
            self._psi(key).record_stall(t_ms, latency_ms)

    def pressure(self, key: str, now_ms: float) -> float:
        return self._psi(key).pressure(now_ms) if key in self.psi else 0.0

    def latency(self, key: str) -> LatencyStats:
        return self._lat(key)
