"""device.idle_share.serve: the share of the traced engine steps' wall
time in which no operation ran on the device (%, profiler)."""


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
