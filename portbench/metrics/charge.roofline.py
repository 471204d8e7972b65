"""charge.roofline: the in-step charge kernel's share of its roofline in
the traced steps: the frozen ``charge_cost`` bound of each step's
charge, at the chains its slots walk in the table it read, over the
device time the profiler gives the kernel (%).  Nothing where the
profiler saw another number of launches than the program's counter."""
from portbench.harness import costs, trace


def read(run):
    tr = run["trace"]
    if run["kind"] != "serve" or not tr or not run["charge_calls"]:
        return None
    dev_s, n = trace.kernel_time(tr, "charge_kernel")
    if n == 0 or n != tr["launches"].get("fused_charge_batch") \
            or n != len(run["charge_calls"]):
        return None
    bound = 0.0
    for c in run["charge_calls"]:
        parent, prog = c["pre"]["parent"], c["pre"]["prog"]
        walk = costs.charge_walks(parent, c["dom"])
        cost = costs.charge_cost(len(parent), prog.shape[1], len(c["dom"]),
                                 [walk])
        bound += costs.bound_s(cost)
    return 100.0 * bound / dev_s
