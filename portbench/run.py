"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout (the program is imported from ``src/``).
Exits 2 and prints no result without the CUDA cards the cell asks for.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and the program's sources, never this directory
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

from portbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
