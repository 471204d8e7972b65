"""step.mfu.prefill: the useful compute of every prefill the window
completed (the frozen ``prefill_flops``: the weight products and causal
attention) over the card's bf16 peak times the window's wall time (%)."""
from portbench.harness import costs


def read(run):
    if run["kind"] != "prefill" or not run["window_s"]:
        return None
    mix = run["mix"]
    flops = run["prefills"] * costs.prefill_flops(run["cfg"], mix["seq_len"],
                                                  mix["batch"])
    return 100.0 * flops / (costs.HW["flops_bf16"] * run["window_s"])
