"""Paper §4 Table 2: quantitative demos of the three mismatches.

granularity    — static memory.max: average-sized limits kill bursty
                 tasks; peak-sized limits waste >90% of the reservation
                 (peak demand <2% of samples) and cap concurrency.
responsiveness — PSI daemon poll+react latency vs 1-2s bursts: kills
                 land after the burst; AgentCgroup throttles in-step.
adaptability   — P95-from-history limits are defeated by 1.8x-20x
                 non-determinism; kill-and-restart loses all progress.

Port of ``benchmarks/mismatch.py`` as a module of the port: the same
replays through the port's policies and host tree (host and numpy only),
the same printed lines and returned dict.

Run: PYTHONPATH=src python -m repro_torch.evaluation.mismatch
"""
import numpy as np

from repro_torch.core import domains as D
from repro_torch.core.policy import (AgentCgroupPolicy, PredictiveP95Policy,
                                     ReactivePSIPolicy, StaticLimitPolicy)
from repro_torch.traces.generator import (generate_spike_corpus,
                                          generate_task, named_trace)
from repro_torch.traces.replay import ReplayConfig, replay


def run():
    tr = [named_trace("dask/dask#11628", seed=1),
          named_trace("sigmavirus24/github3.py#673", seed=2),
          named_trace("sigmavirus24/github3.py#673", seed=3)]
    prios = [D.HIGH, D.LOW, D.LOW]
    print("\n== mismatch analysis (paper §4, Table 2) ==")

    # ---- granularity
    avg = int(np.mean([t.avg_mb for t in tr]))
    peak = int(max(t.peak_mb for t in tr)) + 10
    cfg = ReplayConfig(capacity_mb=5000)
    r_avg = replay(tr, prios, StaticLimitPolicy(limit_mb=avg), cfg)
    pol_peak = StaticLimitPolicy(limit_mb=peak)
    r_peak = replay(tr, prios, pol_peak, cfg)
    # waste: fraction of a peak-sized reservation unused on average
    waste = 1.0 - np.mean([t.avg_mb for t in tr]) / peak
    peak_time_frac = np.mean([
        np.mean(t.mem_mb > 0.9 * t.peak_mb) for t in tr])
    print(f"granularity : memory.max=avg({avg}MB) survival "
          f"{r_avg.survival:.2f}; memory.max=peak({peak}MB) survival "
          f"{r_peak.survival:.2f}, reservation waste {waste * 100:.0f}% "
          f"(paper >90%), peak-demand time {peak_time_frac * 100:.1f}% "
          f"(paper <2%), concurrency {pol_peak.max_concurrency(1100, 0)} "
          f"tasks/1100MB")

    # ---- responsiveness
    cfg = ReplayConfig(capacity_mb=1100)
    r_psi = replay(tr, prios, ReactivePSIPolicy(poll_ms=100, react_ms=40,
                                                pressure_threshold=0.3), cfg)
    r_agent = replay(tr, prios, AgentCgroupPolicy(
        session_high={"sigmavirus24/github3.py#673": 400}), cfg)
    burst_ms = 1.5 * 1000 / 50          # 1-2s bursts at 50x accel
    print(f"responsiveness: burst duration ~{burst_ms:.0f}ms(replay) vs "
          f"PSI poll+react 140ms -> oomd survival {r_psi.survival:.2f} "
          f"(kills after the burst); in-step throttle survival "
          f"{r_agent.survival:.2f} with {r_agent.throttle_count} "
          f"same-allocation delays")

    # ---- adaptability
    hist, tasks = {}, []
    for i in range(4):
        runs = [generate_task(f"t{i}", "glm", seed=s, scale=0.5)
                for s in range(3)]
        hist[f"t{i}"] = [r.peak_mb for r in runs]
        tasks.append(generate_task(f"t{i}", "glm", seed=50 + i, scale=1.3))
    r_pred = replay(tasks, [D.NORMAL] * 4,
                    PredictiveP95Policy(hist, safety=1.1),
                    ReplayConfig(capacity_mb=10 ** 6))
    r_acg = replay(tasks, [D.NORMAL] * 4, AgentCgroupPolicy(),
                   ReplayConfig(capacity_mb=10 ** 6))
    print(f"adaptability: P95-history limits survival {r_pred.survival:.2f} "
          f"under run-to-run variance; AgentCgroup (no prediction) "
          f"{r_acg.survival:.2f}")

    # ---- burst-shape profiles: ONE policy across model trace classes.
    # The mismatches are workload properties, not policy bugs: the same
    # AgentCgroup policy must hold across burst-shape/baseline profiles
    # (Haiku's tall test bursts, GLM's bash-heavy steadiness, and the
    # in-between qwen class) without per-model tuning.
    by_model = {}
    # spike targets matched to each class's burst shape (the 15.4x
    # exemplar was a Haiku task; GLM's bash-heavy traces spike flatter)
    for model, ratio in (("haiku", 15.4), ("glm", 7.0), ("qwen", 10.0)):
        corpus = generate_spike_corpus(4, seed=9, model=model,
                                       duration_s=120.0,
                                       peak_to_avg=ratio)
        r = replay(corpus, [D.NORMAL] * len(corpus), AgentCgroupPolicy(),
                   ReplayConfig(capacity_mb=1500))
        by_model[model] = (r.survival, r.throttle_count, r.peak_pool_mb)
        print(f"profiles    : {model:<6} survival {r.survival:.2f}, "
              f"throttles {r.throttle_count}, "
              f"peak pool {r.peak_pool_mb} MB (untuned policy)")

    return {"granularity": (r_avg.survival, r_peak.survival, waste),
            "responsiveness": (r_psi.survival, r_agent.survival),
            "adaptability": (r_pred.survival, r_acg.survival),
            "profiles": by_model}


if __name__ == "__main__":
    run()
