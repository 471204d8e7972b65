"""engine.step_ms_p50: the median wall time of one engine step in the
window, on the host clock, each step ending in a synchronize (ms)."""
import statistics


def read(run):
    if run["kind"] != "serve" or not run["steps"]:
        return None
    ts = [run["t0"]] + [s["t"] for s in run["steps"]]
    return statistics.median((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
