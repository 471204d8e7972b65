"""Static vs pressure-adaptive soft limits on the spike corpus (§4/§5).

The paper's adaptability mismatch: agent memory is heavy-tailed (15.4x
peak-to-average) AND non-deterministic, so any statically sized
``memory.high`` is wrong most of the time — average-sized limits
throttle every burst, peak-sized limits reserve idle headroom.  The
PSI-style pressure subsystem (``core/pressure.py``) closes the loop:
``AdaptiveController`` watches each session's ``memory.pressure`` and
bumps the soft limit while a burst is actually stalling the domain,
then restores it when pressure decays — the hard ``memory.max`` wall
is never crossed, so tenant isolation is untouched.

Two replays of the same corpus under identical limits:

  * static    — ``memory.high`` = 1.3x the trace average, fixed;
  * adaptive  — same start point + ``AdaptiveController`` polled every
                tick: sustained avg10 above 15% doubles the soft limit
                (up to 3 bumps, capped at ``memory.max``), decay below
                5% restores it.

Reported: throttle events per granted allocation, LOW-task completion
overhead, and the HIGH tenant's P95 allocation latency — the adaptive
arm must win on throttling without worsening the HIGH tenant (the
assertions run in every mode; CI runs ``--quick``).

Run: PYTHONPATH=src python -m repro_torch.traces.adaptive_pressure [--quick]

Port of ``benchmarks/adaptive_pressure.py`` as a module of the port:
the same replays through the port's host tree, the same printed lines
and returned dict.
"""
from repro_torch.core import domains as D
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.core.policy import AgentCgroupPolicy
from repro_torch.traces.generator import generate_spike_corpus
from repro_torch.traces.replay import Replay, ReplayConfig

# generous pool: the binding constraint is the per-session soft limit,
# not pool exhaustion — isolating the adaptability-mismatch failure mode
CAPACITY_MB = 24_000
HIGH_FACTOR = 1.3        # session memory.high = 1.3x the trace average
MAX_FACTOR = 8.0         # session memory.max = 8x that high (hard wall)
# PSI windows sized to the 50x-accelerated replay clock (ms); the
# default 10 s / 60 s windows would never decay inside one replay
PRESSURE_WINDOWS = (300.0, 1500.0)

ADAPTIVE = AdaptiveConfig(high_frac=0.15, low_frac=0.05,
                          bump_factor=2.0, max_bumps=3, cooldown_ms=50.0)


class TightSessionPolicy(AgentCgroupPolicy):
    """AgentCgroup with average-sized session soft limits plus the hard
    ``memory.max`` wall the retuner must never cross."""
    name = "agentcgroup_static"

    def setup(self, sim, tasks) -> None:
        super().setup(sim, tasks)
        for t in tasks:
            high = self.session_high.get(t.trace.task_id, D.UNLIMITED)
            if high < D.UNLIMITED:
                sim.cg.write(self.domain_for(t), "memory.max",
                             int(high * MAX_FACTOR))


class AdaptivePolicy(TightSessionPolicy):
    """Same limits + the pressure-driven retuner polled every tick."""
    name = "agentcgroup_adaptive"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.retuner = None

    def setup(self, sim, tasks) -> None:
        super().setup(sim, tasks)
        sim.cg.pressure_clock(windows=PRESSURE_WINDOWS)
        self.retuner = AdaptiveController(sim.cg, ADAPTIVE)

    def tick(self, sim) -> None:
        super().tick(sim)
        self.retuner.poll(sim.now_ms)


def _arm(traces, prios, policy, cfg) -> dict:
    sim = Replay(traces, prios, policy, cfg)
    res = sim.run()
    allocs = sum(sum(1 for e in t.events if e.delta_mb > 0)
                 for t in sim.tasks)
    lows = [r for t, r in zip(sim.tasks, res.tasks.values())
            if t.priority == D.LOW and r.completed]
    return {
        "summary": res.summary(),
        "throttles": res.throttle_count,
        "throttle_frac": res.throttle_count / max(allocs, 1),
        "survival": res.survival,
        "high_p95_ms": res.latency_of(D.HIGH).p95,
        "low_overhead": (sum(r.overhead for r in lows) / len(lows)
                         if lows else float("nan")),
        "root_psi": sim.cg.read("/", "memory.pressure"),
        "events": list(policy.retuner.events) if getattr(
            policy, "retuner", None) else [],
    }


def run(n: int = 8, seed: int = 1) -> dict:
    traces = generate_spike_corpus(n, seed=seed)
    prios = [D.HIGH] + [D.LOW] * (len(traces) - 1)
    session_high = {t.task_id: max(64, int(t.avg_mb * HIGH_FACTOR))
                    for i, t in enumerate(traces) if prios[i] != D.HIGH}
    cfg = ReplayConfig(capacity_mb=CAPACITY_MB)

    static = _arm(traces, prios,
                  TightSessionPolicy(session_high=session_high), cfg)
    adapt = _arm(traces, prios,
                 AdaptivePolicy(session_high=session_high), cfg)

    bumps = [e for e in adapt["events"] if e.action == "bump_high"]
    restores = [e for e in adapt["events"] if e.action == "restore_high"]
    out = {
        "tasks": len(traces),
        "peak_to_avg": max(t.peak_mb / t.avg_mb for t in traces),
        "static": static["summary"],
        "adaptive": adapt["summary"],
        "throttle_frac_static": static["throttle_frac"],
        "throttle_frac_adaptive": adapt["throttle_frac"],
        "low_overhead_static": static["low_overhead"],
        "low_overhead_adaptive": adapt["low_overhead"],
        "bumps": len(bumps),
        "restores": len(restores),
    }

    print("\n== Pressure-adaptive soft limits vs static (spike corpus) ==")
    print(f"corpus: {out['tasks']} heavy-tailed traces, max peak/avg "
          f"{out['peak_to_avg']:.1f}x (paper: 15.4x); memory.high = "
          f"{HIGH_FACTOR:.1f}x avg, memory.max = {MAX_FACTOR:.0f}x high")
    print(f"throttle events/alloc: static {static['throttle_frac']:.3f} "
          f"({static['throttles']}) -> adaptive "
          f"{adapt['throttle_frac']:.3f} ({adapt['throttles']})")
    print(f"LOW completion overhead: static "
          f"{100 * static['low_overhead']:.1f}% -> adaptive "
          f"{100 * adapt['low_overhead']:.1f}%")
    print(f"HIGH P95 alloc latency: static {static['high_p95_ms']:.3f} ms "
          f"-> adaptive {adapt['high_p95_ms']:.3f} ms")
    print(f"survival: static {static['survival']:.2f} -> adaptive "
          f"{adapt['survival']:.2f}")
    print(f"retuner: {out['bumps']} bump(s), {out['restores']} restore(s); "
          f"root PSI after run: {adapt['root_psi']}")
    if bumps:
        print(f"  first: {bumps[0].render()}")

    # the closed loop must RELIEVE throttling without weakening the
    # walls: fewer throttles, HIGH tenant not worse, nobody dies
    assert adapt["throttles"] < static["throttles"], (
        f"adaptive did not reduce throttling: {adapt['throttles']} vs "
        f"{static['throttles']}")
    assert adapt["high_p95_ms"] <= static["high_p95_ms"] * 1.05 + 1e-9, (
        f"adaptive worsened the HIGH tenant: P95 {adapt['high_p95_ms']} "
        f"vs {static['high_p95_ms']}")
    assert adapt["survival"] >= static["survival"], (
        "adaptive lowered survival")
    assert bumps, "pressure never crossed high_frac: no bumps fired"
    return out


if __name__ == "__main__":
    import sys
    quick = "--quick" in sys.argv
    run(n=4 if quick else 8)
