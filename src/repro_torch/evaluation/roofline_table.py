"""Format the dry-run results (build/dryrun/*.json) into the
§Dry-run / §Roofline tables for EXPERIMENTS.md.

Port of ``benchmarks/roofline_table.py`` as a module of the port: the
port's dry run (``python -m repro_torch.launch.dryrun``) writes one
record a cell into ``build/dryrun`` for one card, with no ``mesh`` key
and a collective term of 0, so the twin prints one table, for that card,
where the source prints one per mesh; the columns and their formats are
the source's.

Run: PYTHONPATH=src python -m repro_torch.evaluation.roofline_table \\
         [--dir build/dryrun]
"""
import argparse
import glob
import json
import os

from repro_torch.analysis.roofline import fmt_seconds
from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.mesh import HW

OUT_DIR = str(DEFAULT_OUT)


def load(out_dir: str = OUT_DIR):
    cells = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            d = json.load(f)
        cells[(d["arch"], d["shape"])] = d
    return cells


def table(out_dir: str = OUT_DIR, markdown: bool = False) -> str:
    cells = load(out_dir)
    lines = []
    sep = " | " if markdown else "  "
    hdr = sep.join([f"{'arch':26s}", f"{'shape':11s}", f"{'fits':4s}",
                    f"{'GiB/dev':>7s}", f"{'compute':>9s}", f"{'memory':>9s}",
                    f"{'collect':>9s}", f"{'dom':>7s}", f"{'useful':>6s}",
                    f"{'RLfrac':>6s}"])
    lines.append(("| " + hdr + " |") if markdown else hdr)
    if markdown:
        lines.append("|" + "|".join(["---"] * 10) + "|")
    for (arch, shape), d in sorted(cells.items()):
        if not d.get("applicable"):
            row = [f"{arch:26s}", f"{shape:11s}", "skip", "", "", "", "",
                   "", "", ""]
        elif "error" in d:
            row = [f"{arch:26s}", f"{shape:11s}", "ERR", "", "", "", "",
                   "", "", ""]
        else:
            r, mem = d["roofline"], d["memory"]
            row = [f"{arch:26s}", f"{shape:11s}",
                   "yes" if mem["fits_hbm"] else "NO",
                   f"{mem['per_device_bytes'] / 2**30:7.1f}",
                   f"{fmt_seconds(r['compute_s']):>9s}",
                   f"{fmt_seconds(r['memory_s']):>9s}",
                   f"{fmt_seconds(r['collective_s']):>9s}",
                   f"{r['dominant'][:-2]:>7s}",
                   f"{r['useful_flop_ratio']:6.2f}",
                   f"{r['roofline_fraction']:6.3f}"]
        lines.append(("| " + sep.join(row) + " |") if markdown
                     else sep.join(row))
    return "\n".join(lines)


def run(out_dir: str = OUT_DIR) -> str:
    """Print the table for the one card; returns it."""
    text = table(out_dir)
    print(f"\n== roofline baselines — one {HW['name']} ==")
    print(text)
    return text


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=OUT_DIR,
                    help="the dry run's records (its --out)")
    run(ap.parse_args(argv).dir)


if __name__ == "__main__":
    main()
