"""ssd_scan.roofline: the SSD scan's share of its roofline in the traced
prefills: the frozen ``ssd_cost`` bound of each call over the device
time the profiler gives its three kernels (chunk states, the pass
between chunks, the chunk outputs) (%).  Nothing where the profiler saw
another number of kernels than three a counted call."""
from portbench.harness import costs, trace

KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_chunk_scan_kernel")


def read(run):
    tr = run["trace"]
    if run["kind"] != "prefill" or not tr:
        return None
    calls = tr["launches"].get("ssd_scan", 0)
    dev_s, n = trace.kernel_time(tr, *KERNELS)
    if calls == 0 or n != 3 * calls:
        return None
    cfg = run["cfg"]
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    c = costs.ssd_cost(run["mix"]["batch"], run["mix"]["seq_len"],
                       s["n_ssm_heads"], d_in // s["n_ssm_heads"],
                       s["d_state"], chunk=cfg["perf"]["scan_chunk"],
                       dtype=cfg["dtype"])
    return 100.0 * calls * costs.bound_s(c) / dev_s
