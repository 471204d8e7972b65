"""mla_decode.roofline: the latent decode kernel's share of its roofline
in the traced steps: the least time its calls could take at the live
rows (the frozen ``costs_mla.mla_decode_cost``, one call an MLA layer a
step) over the device time the profiler gives its kernel (%).  Nothing
where the profiler saw no such kernel, or another number of launches
than the program's counter."""
from portbench.harness import costs, costs_mla, trace


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or not tr or not run["cfg"].get("mla"):
        return None
    dev_s, n = trace.kernel_time(tr, "mla_decode_kernel")
    steps = len(tr["outs"])
    if n == 0 or n != tr["launches"].get("mla_decode") or n % steps:
        return None
    cfg = run["cfg"]
    m = cfg["mla"]
    bound = 0.0
    for step in tr["outs"]:
        live = [int(x) + 1 for x in step["lengths"]]
        c = costs_mla.mla_decode_cost(len(live), cfg["n_heads"],
                                      m["kv_lora_rank"],
                                      m["qk_rope_head_dim"], live,
                                      cfg["dtype"])
        bound += n // steps * costs.bound_s(c)
    return 100.0 * bound / dev_s
