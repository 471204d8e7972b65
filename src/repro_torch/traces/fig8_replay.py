"""Paper §6 Fig 8: multi-tenant trace replay, baseline vs AgentCgroup.

(a) tight memory  — 1100 MB pool vs ~1233 MB combined demand:
    OOM survival rate (paper: 66% -> 100%).
(b) moderate memory — 1300 MB pool: HIGH-priority P95 allocation
    latency (paper: 70.97 -> 50.14 ms, -29%), P50 ~unchanged (+0.3%),
    HIGH completion overhead (paper: +2.8%), throttle delay triggers
    (paper: 239).

Port of ``benchmarks/fig8_replay.py`` as a module of the port:
the same replays through the port's host tree, the same printed lines
and returned dict.

Run: PYTHONPATH=src python -m repro_torch.traces.fig8_replay
"""
from repro_torch.core import domains as D
from repro_torch.core.events import Ev
from repro_torch.core.policy import AgentCgroupPolicy, NoIsolationPolicy
from repro_torch.traces.generator import named_trace
from repro_torch.traces.replay import ReplayConfig, replay

LOWHIGH = {"sigmavirus24/github3.py#673": 400}


def traces():
    return ([named_trace("dask/dask#11628", seed=1),
             named_trace("sigmavirus24/github3.py#673", seed=2),
             named_trace("sigmavirus24/github3.py#673", seed=3)],
            [D.HIGH, D.LOW, D.LOW])


def run():
    tr, prios = traces()
    out = {}
    # uncontended reference for overhead accounting
    ref = replay(tr, prios, NoIsolationPolicy(),
                 ReplayConfig(capacity_mb=10 ** 7))
    ref_hi = list(ref.tasks.values())[0].finish_ms

    for cap, tag in ((1100, "tight"), (1300, "moderate")):
        cfg = ReplayConfig(capacity_mb=cap)
        base = replay(tr, prios, NoIsolationPolicy(), cfg)
        agent = replay(tr, prios, AgentCgroupPolicy(session_high=LOWHIGH),
                       cfg)
        bh, ah = base.latency_of(D.HIGH), agent.latency_of(D.HIGH)
        hi_base = list(base.tasks.values())[0]
        hi_agent = list(agent.tasks.values())[0]
        out[tag] = {
            "survival_base": base.survival,
            "survival_agent": agent.survival,
            "high_p95_base_ms": bh.p95,
            "high_p95_agent_ms": ah.p95,
            "high_p95_delta": (ah.p95 / bh.p95 - 1) if bh.p95 else 0.0,
            "high_p50_base_ms": bh.p50,
            "high_p50_agent_ms": ah.p50,
            "throttle_triggers": agent.throttle_count,
            "freezes": agent.log.count(Ev.FREEZE),
            "high_overhead_base": (hi_base.finish_ms / ref_hi - 1
                                   if hi_base.completed else float("nan")),
            "high_overhead_agent": hi_agent.finish_ms / ref_hi - 1,
        }

    print("\n== Fig 8 trace replay ==")
    t, m = out["tight"], out["moderate"]
    print(f"(a) tight 1100MB   survival: base {t['survival_base']:.2f} -> "
          f"agentcgroup {t['survival_agent']:.2f}   (paper 0.66 -> 1.00)")
    ob = t["high_overhead_base"]
    ob_s = f"{ob*100:+.1f}%" if ob == ob else "killed"
    print(f"    HIGH overhead: base {ob_s} -> "
          f"agent {t['high_overhead_agent']*100:+.1f}%  (paper +2.8%)")
    print(f"(b) moderate 1300MB HIGH P95: {m['high_p95_base_ms']:.2f} -> "
          f"{m['high_p95_agent_ms']:.2f} ms "
          f"({m['high_p95_delta']*100:+.1f}%)  (paper 70.97 -> 50.14, -29%)")
    print(f"    HIGH P50: {m['high_p50_base_ms']:.2f} -> "
          f"{m['high_p50_agent_ms']:.2f} ms            (paper +0.3%)")
    print(f"    throttle delay triggers: {m['throttle_triggers']} "
          f"(paper 239); freezes: {m['freezes']}")
    return out


if __name__ == "__main__":
    run()
