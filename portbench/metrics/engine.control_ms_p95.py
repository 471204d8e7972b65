"""engine.control_ms_p95: the 95th percentile, over the window's engine
steps, of the host time each spent on the control plane (the phases
flush, policy, inputs, sessions and daemon of the program's step clock,
``repro_torch.tracing``), ms: the steps that freeze, thaw or admit.
Nothing where the program keeps no step clock or fewer than 20 of its
steps lie in the window."""
import statistics

CONTROL = ("flush", "policy", "inputs", "sessions", "daemon")


def read(run):
    if run["kind"] != "serve":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    st = tracing.steps()
    inside = ((st["start_ns"] >= run["t0"] * 1e9)
              & (st["end_ns"] <= run["t1"] * 1e9))
    if inside.sum() < 20:
        return None
    ms = sum(st[p][inside] for p in CONTROL) / 1e6
    return statistics.quantiles(ms, n=20)[18]
