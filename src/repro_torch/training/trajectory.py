"""The same training steps in bf16 and in f32, from the same weights and
batches: how far the bf16 loss trajectory drifts from the f32 one.

llama3.2-3b cut to 2 layers, 8 steps at batch 1 and train_4k's 4096
positions, with ``launch/train.py``'s optimizer schedule (lr 1e-3,
cosine, warmup ``max(steps // 20, 5)``).  The weights are drawn once in
bf16 and copied to f32 for the f32 run.  Attention goes through the
flash wrappers: on the card the CUDA kernels of each dtype, on the CPU
their plain versions.  ``verdict`` holds the bf16 losses of the warmup's
steps to ``REL_BAR``; after them the f32 run itself diverges at this
rate, and two diverged runs hold nothing to each other.

    PYTHONPATH=src python -m repro_torch.training.trajectory \\
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.controller import resolve_device
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import model as M
from repro_torch.perf import DEFAULT_PERF, replace as perf_replace
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

ARCH = "llama3.2-3b"
LAYERS = 2
STEPS = 8
BATCH = 1
SEQ = 4096
LR = 1e-3
WARMUP = max(STEPS // 20, 5)
# the losses held: those of the steps before the rate reaches its peak.
# At full width the f32 run diverges right after them (11.30 -> 21.39 at
# step 5, 25.54 at step 7 on an H100), so later steps are printed only.
HELD = range(WARMUP)
# (name, dtype) of the two runs
RUNS = (("bf16", "bfloat16"), ("f32", "float32"))

# The bar for the bf16 losses of the held steps, relative to f32: twice
# the most that the command above (the miniature: d 128, vocab 512, 2
# layers, seq 4096, plain versions) drifts in them.  On an H100 at full
# width the kernels' bf16 run drifts at most 1.43e-4 there, as bf16
# through the plain attention does (1.41e-4).
CPU_REL_DRIFT = 3.34e-4
REL_BAR = 2 * CPU_REL_DRIFT


def run_losses(cfg, params, data) -> list:
    """``STEPS`` train steps of ``cfg`` from ``params`` (updated in
    place) with ``remat="dots"`` and the training driver's schedule; the
    loss of each step."""
    perf = perf_replace(DEFAULT_PERF, remat="dots")
    opt = OptConfig(schedule=cfg.schedule, total_steps=STEPS,
                    warmup_steps=WARMUP, lr=LR)
    step_fn = make_train_step(cfg, perf, opt)
    state = init_train_state(cfg, params, perf)
    losses = []
    for i in range(STEPS):
        params, state, metrics = step_fn(params, state, data.at(i), i)
        losses.append(float(metrics["loss"]))
    return losses


def model_config(full_width: bool = True):
    """``ARCH`` at ``LAYERS`` layers, at full width or as its miniature."""
    cfg = get_config(ARCH)
    return dataclasses.replace(cfg if full_width else reduced(cfg),
                               n_layers=LAYERS)


def compare(cfg, *, seed: int = 0, device="cuda") -> dict:
    """``{name: losses}`` of each run of ``RUNS``, both from the same
    weights (drawn once in bf16) and batches."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = M.init_params(dataclasses.replace(cfg, dtype="bfloat16"), gen,
                         device=dev)
    out = {}
    for name, dtype in RUNS:
        params = tree_map(lambda p: p.detach().to(
            torch.float32 if dtype == "float32" else p.dtype, copy=True),
            init)
        data = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch=BATCH,
                            seq=SEQ, device=dev)
        out[name] = run_losses(dataclasses.replace(cfg, dtype=dtype),
                               params, data)
        del params
    return out


def rel_drift(losses: list, against: list) -> list:
    """Each step's ``|a - b| / |b|``."""
    return [abs(a - b) / abs(b) for a, b in zip(losses, against)]


def verdict(runs: dict) -> dict:
    """The bf16 run's relative drift from the f32 run at every step;
    ``over`` lists the held steps whose drift is not within ``REL_BAR``."""
    drift = rel_drift(runs["bf16"], runs["f32"])
    return {"bf16_rel_drift": drift, "held_steps": list(HELD),
            "rel_bar": REL_BAR,
            "max_held_drift": max(drift[i] for i in HELD),
            "over": [i for i in HELD if not drift[i] <= REL_BAR]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family miniature (d 128, vocab 512)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    runs = compare(model_config(not args.reduced), device=args.device)
    print(json.dumps({"arch": ARCH, "reduced": args.reduced,
                      "layers": LAYERS, "seq": SEQ, "batch": BATCH,
                      "runs": runs, **verdict(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
