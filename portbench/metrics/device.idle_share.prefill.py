"""device.idle_share.prefill: the share of the traced prefills' wall
time in which no operation ran on the device (%, profiler)."""


def read(run):
    tr = run["trace"]
    if run["kind"] != "prefill" or not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
