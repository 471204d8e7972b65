"""step.mfu.serve: the useful compute of every token the window served
(the frozen ``token_flops`` at each token's live context) over the
card's bf16 peak times the window's wall time (%)."""
from portbench.harness import costs


def read(run):
    if run["kind"] != "serve" or not run["window_s"]:
        return None
    cfg = run["cfg"]
    base = costs.token_flops(cfg, 0)
    per_key = costs.token_flops(cfg, 1) - base
    flops = sum(s["granted"] * base + s["granted_keys"] * per_key
                for s in run["steps"])
    return 100.0 * flops / (costs.HW["flops_bf16"] * run["window_s"])
