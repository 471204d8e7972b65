"""enforcement.denied_share: the running slot-steps of the window whose
charge was denied (throttled, frozen or at a hard limit), over all the
running slot-steps (%).  A denied slot's decode is wasted device work."""


def read(run):
    if run["kind"] != "serve":
        return None
    asked = sum(s["asked"] for s in run["steps"])
    granted = sum(s["granted"] for s in run["steps"])
    return 100.0 * (asked - granted) / asked if asked else None
