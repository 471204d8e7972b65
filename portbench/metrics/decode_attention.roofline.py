"""decode_attention.roofline: the decode kernel's share of its roofline
in the traced steps: the least time its calls could take at the live
lengths (the frozen ``decode_cost``, one call an attention layer a
step) over the device time the profiler gives its kernel (%).  Nothing
where the profiler saw another number of launches than the program's
counter."""
from portbench.harness import costs, trace


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or not tr:
        return None
    dev_s, n = trace.kernel_time(tr, "decode_mma_kernel")
    if n == 0 or n != tr["launches"].get("decode_attention"):
        return None
    cfg = run["cfg"]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    bound = 0.0
    for step in tr["outs"]:
        live = [int(x) + 1 for x in step["lengths"]]
        c = costs.decode_cost(len(live), cfg["n_heads"], cfg["n_kv_heads"],
                              hd, hd, live, cfg["dtype"])
        bound += costs.attention_layers(cfg) * costs.bound_s(c)
    return 100.0 * bound / dev_s
