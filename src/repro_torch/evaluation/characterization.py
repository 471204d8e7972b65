"""Paper §3 (Figs 1-7, Table 1): workload characterization re-measured
from generated trace datasets, printed next to the paper's numbers.

Port of ``benchmarks/characterization.py`` as a module of the port: the
same statistics from the port's trace generator (numpy only), the same
printed table and returned rows.

Run: PYTHONPATH=src python -m repro_torch.evaluation.characterization
"""
import numpy as np

from repro_torch.traces.generator import generate_dataset, named_trace


def _burst_stats(ds, thr_over_base=112.0):
    in_call = total = 0
    for t in ds:
        thr = t.baseline_mb + thr_over_base
        for i, m in enumerate(t.mem_mb):
            if m > thr:
                total += 1
                in_call += t.in_tool_call(float(i))
    return (in_call / total) if total else float("nan")


def run(n_glm: int = 40, n_haiku: int = 20, seed: int = 7):
    glm = generate_dataset("glm", n_glm, seed=seed)
    haiku = generate_dataset("haiku", n_haiku, seed=seed + 1)
    both = glm + haiku
    rows = []

    def add(name, ours, paper):
        rows.append((name, ours, paper))

    add("task_duration_glm_min", np.mean([t.duration_s for t in glm]) / 60,
        "10.8")
    add("task_duration_haiku_min",
        np.mean([t.duration_s for t in haiku]) / 60, "5.8")
    add("init_frac_of_total",
        np.mean([t.init_s / t.total_s for t in both]), "0.31-0.48")
    tool_frac = np.mean([t.tool_time_s() / t.duration_s for t in both])
    add("tool_frac_of_active", tool_frac, "0.36-0.42")
    os_frac = np.mean([(t.init_s + t.tool_time_s()) / t.total_s
                       for t in both])
    add("os_level_frac_of_total", os_frac, "0.56-0.74")
    add("framework_baseline_mb", np.mean([t.baseline_mb for t in both]),
        "185 (183/188)")
    bash = [c for t in glm for c in t.tool_calls if c.tool == "Bash"]
    tool_time = sum(c.dur_s for t in glm for c in t.tool_calls)
    add("bash_share_of_tool_time_glm",
        sum(c.dur_s for c in bash) / tool_time, "0.981")
    test_t = sum(c.dur_s for c in bash if c.category == "test")
    add("test_share_of_bash_glm", test_t / sum(c.dur_s for c in bash),
        "0.437")
    peaks = np.array([t.peak_mb for t in both])
    add("peak_mb_range", f"{peaks.min():.0f}-{peaks.max():.0f}", "197-4000")
    add("peak_cv", peaks.std() / peaks.mean(), "1.47")
    pyd = named_trace("pydicom/pydicom#2022", seed=0)
    add("pydicom_peak_to_avg", pyd.peak_to_avg, "15.4")
    add("bursts_in_tool_calls_frac", _burst_stats(glm), "0.673 (glm)")
    retry = np.mean([1.0 if t.retry_groups() else 0.0 for t in glm])
    add("retry_task_frac_glm", retry, "0.97")
    add("retry_groups_per_task_glm",
        np.mean([len(t.retry_groups()) for t in glm]), "3.9")
    acc = [sum(c.retained_mb for c in t.tool_calls) for t in glm]
    add("max_retained_mb", max(acc), "<=502")
    add("cpu_avg_pct_glm", np.mean([t.cpu_pct.mean() for t in glm]),
        "7.6")
    # non-determinism: same task, different seeds
    from repro_torch.traces.generator import generate_task
    runs = [generate_task("iterative/dvc#777", "glm", seed=s)
            for s in range(5)]
    durs = [r.duration_s for r in runs]
    add("same_task_duration_spread", max(durs) / min(durs), "1.8")

    print("\n== characterization (paper §3) ==")
    print(f"{'metric':34s} {'ours':>12s}   paper")
    for name, ours, paper in rows:
        o = f"{ours:.3f}" if isinstance(ours, (int, float)) else str(ours)
        print(f"{name:34s} {o:>12s}   {paper}")
    return rows


if __name__ == "__main__":
    run()
