"""The readings a cell's limits are set from: the program's compared
numbers and those of its control, over many seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seconds <s> \
        --seeds 11 12 13 ...

For each seed it runs the cell as ``run.py`` does (set-up, the window,
the comparison) and, on the same prompts and tokens, the control: the
plain reference computed with float8 weight products
(``reference/common.py``), which must fail the limit.  Prints one JSON
line a seed: the compared numbers (``control_gap`` or
``control_rel_err`` are the control's), the end-to-end metrics and the
set-up time.  Needs the card, as ``run.py`` does.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from portbench.harness import bench  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args()
    bench.process_env(bench.ROOT)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        ctx = bench.load_cell(bench.ROOT, args.workload)
        ctx["control"] = bool(args.control)
        t = time.time()
        ctx["process_start"] = t
        out = bench.execute(ctx, seed, args.seconds, 0, device)
        print(json.dumps({"seed": seed, "numbers": out["numbers"],
                          "metrics": out["result"]["metrics"],
                          "correct": out["result"]["correct"],
                          "notes": out["notes"],
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
