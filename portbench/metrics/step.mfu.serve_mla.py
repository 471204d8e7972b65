"""step.mfu.serve_mla: the useful compute of every token the window
served over the card's bf16 peak times the window's wall time (%), for
an MLA model: the frozen ``costs_mla.mla_decode_flops`` at each token's
live context, the routed experts' part from the program's step clock
(``moe_assigned``, the held experts' assignments of the slots that
advanced a token, over the window's steps, ``repro_torch.tracing``).  Nothing where the model has no latent
attention or the program's clock has no ``moe_assigned`` column or no
step in the window."""
from portbench.harness import costs, costs_mla


def read(run):
    if run["kind"] != "serve" or not run["window_s"] or \
            not run["cfg"].get("mla"):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    st = tracing.steps()
    if "moe_assigned" not in st:
        return None
    inside = ((st["start_ns"] >= run["t0"] * 1e9)
              & (st["end_ns"] <= run["t1"] * 1e9))
    if not inside.any():
        return None
    cfg = run["cfg"]
    base = costs_mla.mla_decode_flops(cfg, 0)
    per_key = costs_mla.mla_decode_flops(cfg, 1) - base
    per_assigned = costs_mla.mla_decode_flops(cfg, 0, 1) - base
    steps = run["steps"]
    granted = sum(s["granted"] for s in steps)
    assigned = float(st["moe_assigned"][inside].sum())
    flops = (granted * base + sum(s["granted_keys"] for s in steps) * per_key
             + assigned * per_assigned)
    return 100.0 * flops / (costs.HW["flops_bf16"] * run["window_s"])
