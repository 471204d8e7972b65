"""flash_fwd.roofline: the flash forward's share of its roofline in the
traced prefills: the frozen ``flash_cost`` bound of each call (causal,
the prompt's length, the configuration's heads) over the device time
the profiler gives its kernel (%).  Nothing where the profiler saw
another number of launches than the program's counter."""
from portbench.harness import costs, trace


def read(run):
    tr = run["trace"]
    if run["kind"] != "prefill" or not tr:
        return None
    dev_s, n = trace.kernel_time(tr, "fwd_wgmma_kernel")
    if n == 0 or n != tr["launches"].get("flash_fwd"):
        return None
    cfg, S = run["cfg"], run["mix"]["seq_len"]
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    c = costs.flash_cost(run["mix"]["batch"], S, cfg["n_heads"], hd, S,
                         cfg["n_kv_heads"], hd, causal=True,
                         dtype=cfg["dtype"])
    return 100.0 * n * costs.bound_s(c) / dev_s
