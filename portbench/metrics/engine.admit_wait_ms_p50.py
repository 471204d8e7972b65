"""engine.admit_wait_ms_p50: the median wall time from a session's
submission to its admission to a slot, over the sessions of the engine
that stepped in the window which it admitted in the window, and those
still waiting at its end with their wait so far (ms, the program's
admission records, ``repro_torch.tracing``).  Nothing where the program
keeps no such records or none lies in the window."""
import statistics

import numpy as np


def read(run):
    if run["kind"] != "serve":
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t0, t1 = run["t0"] * 1e9, run["t1"] * 1e9
    st = tracing.steps()
    inside = (st["start_ns"] >= t0) & (st["end_ns"] <= t1)
    se = tracing.sessions()
    sub, adm = se["submit_ns"], se["admit_ns"]
    mine = np.isin(se["engine"], st["engine"][inside])
    admitted = mine & (adm >= t0) & (adm <= t1)
    waiting = mine & (sub <= t1) & ((adm < 0) | (adm > t1))
    waits = np.concatenate([adm[admitted] - sub[admitted],
                            t1 - sub[waiting]]) / 1e6
    if not len(waits):
        return None
    return statistics.median(waits)
