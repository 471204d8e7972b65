"""engine.high_gap_ms_p95: the 95th percentile, over the window, of the
wall time between successive tokens granted to a session of a HIGH
tenant, denied steps and time frozen included (ms, host clock)."""
import statistics

HIGH = 2


def read(run):
    if run["kind"] != "serve":
        return None
    gaps = []
    for log in run["logs"].values():
        if log.priority != HIGH:
            continue
        ts = [t for t in log.grant_times if run["t0"] <= t <= run["t1"]]
        gaps.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20)[18]
