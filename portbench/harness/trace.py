"""The traced block of a ``--trace 1`` run: ``torch.profiler`` over a few
steps or prefills that follow the window, reduced in memory to what the
per-layer metrics read.

* ``kernels``: each device operation's name, its device seconds and its
  count over the block;
* ``busy_s``: the seconds in which some operation ran on the device
  (the union of their intervals), and ``window_s``, the block's wall
  time from its first host operation to its last device operation;
* ``idle_gaps``: the gaps between device operations, each named by the
  innermost host operation running at its middle, summed by name;
* ``launches``: the program's own launch counters over the block.

Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import time

import torch


def traced(fn, calls: int, sync, counters=None) -> dict:
    """Run ``fn`` ``calls`` times under the profiler and reduce it."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    before = dict(counters()) if counters else {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs = [fn() for _ in range(calls)]
        sync()
        wall = time.perf_counter() - t0
    after = dict(counters()) if counters else {}
    out = reduce_events(prof.events())
    out["host_wall_s"] = wall
    out["calls"] = calls
    out["outs"] = outs
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after}
    return out


def _interval(e) -> tuple:
    return e.time_range.start, e.time_range.end


def reduce_events(events) -> dict:
    """Kernel sums, busy time, the block's length and the named idle
    gaps from a profiler's events (times in microseconds)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        if e.device_type == cuda:
            dev.append(e)
        else:
            host.append(e)
    kernels: dict = {}
    for e in dev:
        s, c = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (s + (e.time_range.end - e.time_range.start) / 1e6,
                           c + 1)
    spans = sorted(_interval(e) for e in dev)
    busy, gaps = 0.0, []
    cur = None
    for s, t in spans:
        if cur is None:
            cur = [s, t]
        elif s <= cur[1]:
            cur[1] = max(cur[1], t)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, t]
    if cur is not None:
        busy += cur[1] - cur[0]
    starts = [_interval(e)[0] for e in host] + [s for s, _ in spans]
    ends = [_interval(e)[1] for e in host] + [t for _, t in spans]
    window = (max(ends) - min(starts)) if starts else 0.0
    return {"kernels": kernels, "busy_s": busy / 1e6,
            "window_s": window / 1e6,
            "idle_gaps": name_gaps(gaps, host)}


def name_gaps(gaps: list, host: list) -> dict:
    """Sum the gaps' seconds by the innermost host operation that spans
    each gap's middle ("host, no operation" where none does)."""
    ivs = sorted((_interval(e) + (e.name,) for e in host),
                 key=lambda x: x[0])
    starts = [s for s, _, _ in ivs]
    out: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        best = None
        # the spans that start before the middle: scan back from there
        i = bisect.bisect_right(starts, mid)
        for s, t, name in reversed(ivs[max(0, i - 400):i]):
            if t >= mid and (best is None or t - s < best[1] - best[0]):
                best = (s, t, name)
        name = best[2] if best else "host, no operation"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def kernel_time(tr: dict, *parts) -> tuple:
    """Device seconds and launches of the kernels whose names hold any
    of ``parts``."""
    s, c = 0.0, 0
    for name, (t, n) in tr["kernels"].items():
        if any(p in name for p in parts):
            s += t
            c += n
    return s, c


def breakdown(tr: dict, top: int = 10) -> dict:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(tr["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], t] for n, (t, _) in ops],
            "idle_gaps": [[n[:120], t] for n, t in gaps]}
