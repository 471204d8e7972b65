"""engine.issue_ms_p50: the median, over the window's engine steps, of
the phase ``issue`` of the program's step clock (``repro_torch.
tracing``): the host's time to copy the step's inputs to the device and
issue the in-step charge, the decode and the gated merge (ms).  Nothing
where the program keeps no step clock or none of its steps lies in the
window."""
import statistics


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
    return statistics.median(st["issue"][inside] / 1e6)
