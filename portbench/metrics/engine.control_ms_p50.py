"""engine.control_ms_p50: the median, over the window's engine steps, of
the host time each spent on the control plane: the phases flush, policy,
inputs, sessions and daemon of the program's step clock
(``repro_torch.tracing``), ms.  Nothing where the program keeps no step
clock or none of its steps lies in the window."""
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
    if not inside.any():
        return None
    return statistics.median(sum(st[p][inside] for p in CONTROL) / 1e6)
