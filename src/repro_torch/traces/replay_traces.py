"""Replay paper-calibrated agent traces under every resource-control
policy and print the survival / latency / overhead comparison —
the fastest way to see the paper's three mismatches and their fix.

Run: PYTHONPATH=src python -m repro_torch.traces.replay_traces

Port of ``examples/replay_traces.py`` as a module of the port:
the same replays through the port's host tree, the same printed lines
and returned dict.
"""
import numpy as np

from repro_torch.core import domains as D
from repro_torch.core.policy import (AgentCgroupPolicy, NoIsolationPolicy,
                                     PredictiveP95Policy, ReactivePSIPolicy,
                                     StaticLimitPolicy)
from repro_torch.traces.generator import generate_task, named_trace
from repro_torch.traces.replay import ReplayConfig, replay


def main() -> list:
    """Print the comparison table; returns each policy's summary."""
    traces = [named_trace("dask/dask#11628", seed=1),
              named_trace("sigmavirus24/github3.py#673", seed=2),
              named_trace("sigmavirus24/github3.py#673", seed=3)]
    prios = [D.HIGH, D.LOW, D.LOW]
    avg = int(np.mean([t.avg_mb for t in traces]))
    hist = {t.task_id: [t.peak_mb * 0.6] for t in traces}  # stale history
    policies = [
        NoIsolationPolicy(),
        StaticLimitPolicy(limit_mb=avg),
        ReactivePSIPolicy(),
        PredictiveP95Policy(hist),
        AgentCgroupPolicy(session_high={"sigmavirus24/github3.py#673": 400}),
    ]
    cfg = ReplayConfig(capacity_mb=1100)
    print(f"pool 1100 MB, demand ~{sum(t.peak_mb for t in traces):.0f} MB "
          f"(1 HIGH + 2 LOW sessions)\n")
    print(f"{'policy':16s} {'survival':>8s} {'HIGH P95':>9s} "
          f"{'throttles':>9s} {'kills':>6s} {'freezes':>7s}")
    out = []
    for pol in policies:
        r = replay(traces, prios, pol, cfg)
        s = r.summary()
        out.append(s)
        print(f"{s['policy']:16s} {s['survival']:8.2f} "
              f"{s['high_p95_ms']:8.2f}m {s['throttles']:9d} "
              f"{s['oom_kills']:6d} {s['freezes']:7d}")
    return out


if __name__ == "__main__":
    main()
