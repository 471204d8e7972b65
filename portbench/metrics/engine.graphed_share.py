"""engine.graphed_share: the share of the window's engine steps whose
device work the program issued as one CUDA graph's replay (the column
``graphed`` of its step clock, ``repro_torch.tracing``), in %.  Nothing
where the program keeps no step clock, its clock has no such column, or
none of its steps lies in the window."""


def read(run):
    if run["kind"] != "serve":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    st = tracing.steps()
    if "graphed" not in st:
        return None
    inside = ((st["start_ns"] >= run["t0"] * 1e9)
              & (st["end_ns"] <= run["t1"] * 1e9))
    if not inside.any():
        return None
    return 100.0 * float(st["graphed"][inside].mean())
