"""Semantic OOM escalation vs. a no-retry hard limit (paper §6).

The paper's waste argument: agentic memory is heavy-tailed (measured
15.4x peak-to-average spikes), so a hard per-tool ``memory.max`` sized
for the typical call kills the spikes — and a kill without retry
discards the task's entire resident set.  The escalation loop absorbs
the same kill at tool-call granularity: the killed lease's ``OomEvent``
is negotiated into a bounded exponentially-growing grant and the call
replays under the new limit.

Two replays of the same heavy-tailed corpus, identical tool limits:

  * static      — ``lease_max_factor`` only: a breach is fatal.
  * escalating  — same limits + ``EscalationPolicy``: breach -> kill
                  the CALL -> negotiate -> retry; the ``WasteLedger``
                  accounts discarded pages per attempt vs. the
                  baseline's whole-task loss.

Run: PYTHONPATH=src python -m repro_torch.traces.escalation_waste [--quick]

Port of ``benchmarks/escalation_waste.py`` as a module of the port:
the same replays through the port's host tree, the same printed lines
and returned dict.
"""
from repro_torch.core import domains as D
from repro_torch.core.escalation import EscalationPolicy
from repro_torch.core.policy import AgentCgroupPolicy
from repro_torch.traces.generator import generate_spike_corpus
from repro_torch.traces.replay import ReplayConfig, replay

# generous pool: the binding constraint is the per-tool lease max, not
# pool exhaustion — isolating the granularity-mismatch failure mode
CAPACITY_MB = 24_000
LEASE_MAX_FACTOR = 1.0          # hard lease max = the intent-hinted high


def run(n: int = 8, seed: int = 1) -> dict:
    traces = generate_spike_corpus(n, seed=seed)
    prios = [D.NORMAL] * len(traces)
    cfg = ReplayConfig(capacity_mb=CAPACITY_MB)

    static = replay(traces, prios,
                    AgentCgroupPolicy(lease_max_factor=LEASE_MAX_FACTOR),
                    cfg)
    esc = replay(traces, prios,
                 AgentCgroupPolicy(lease_max_factor=LEASE_MAX_FACTOR,
                                   escalation=EscalationPolicy()),
                 cfg)
    led = esc.escalation
    out = {
        "tasks": len(traces),
        "peak_to_avg": max(t.peak_mb / t.avg_mb for t in traces),
        "survival_static": static.survival,
        "survival_escalating": esc.survival,
        "killed_calls": led["killed_calls"],
        "recovered_calls": led["recovered_calls"],
        "recovery_rate": led["recovery_rate"],
        "kills": led["kills"],
        "exhausted": led["exhausted"],
        "attempt_waste_mb": led["attempt_waste_pages"],
        "baseline_waste_mb": led["baseline_waste_pages"],
        "saved_mb": led["saved_pages"],
    }

    print("\n== Semantic OOM escalation: retry completion & waste ==")
    print(f"corpus: {out['tasks']} heavy-tailed traces, max peak/avg "
          f"{out['peak_to_avg']:.1f}x (paper: 15.4x), pool {CAPACITY_MB} MB, "
          f"lease max = {LEASE_MAX_FACTOR:.1f}x hinted high")
    print(f"task survival:   static {out['survival_static']:.2f} -> "
          f"escalating {out['survival_escalating']:.2f}")
    print(f"killed tool calls: {out['killed_calls']} "
          f"({out['kills']} kill(s) over all attempts, "
          f"{out['exhausted']} exhausted)")
    print(f"retry completion: {out['recovered_calls']}/{out['killed_calls']} "
          f"({out['recovery_rate'] * 100:.0f}%)")
    print(f"waste: no-retry baseline discards {out['baseline_waste_mb']} MB "
          f"(whole tasks); escalation discards {out['attempt_waste_mb']} MB "
          f"(per-attempt) -> {out['saved_mb']} MB saved")

    # the paper's claim, asserted (CI runs ``--quick``): escalation
    # turns fatal breaches into recoveries and discards strictly less
    assert out["survival_escalating"] >= out["survival_static"], (
        "escalation lowered task survival")
    assert out["killed_calls"] > 0, (
        "corpus never breached a lease max: nothing was exercised")
    assert out["recovered_calls"] > 0, "no killed call recovered"
    assert out["saved_mb"] > 0, (
        "escalation did not reduce discarded work vs the no-retry baseline")
    return out


if __name__ == "__main__":
    import sys
    quick = "--quick" in sys.argv
    run(n=4 if quick else 8)
