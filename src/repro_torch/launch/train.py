"""Fault-tolerant training driver (port of ``repro/launch/train.py``).

  * resume from the latest checkpoint (bit-exact: data is a pure function
    of (seed, step), optimizer state is checkpointed with params);
  * periodic async checkpoints with keep-k GC and atomic writes — a
    mid-write crash leaves the previous checkpoint intact;
    ``--ckpt-every 0`` writes none;
  * failure injection (``--crash-at N``) to demonstrate restart;
  * straggler watchdog: per-step wall times against a rolling median;
  * optional int8 gradient compression with error feedback.

It runs on the card unless ``--device cpu`` is given.  ``--reduced``
trains the same-family miniature in f32 with no remat; otherwise the
full-width model trains in its dtype with ``remat="dots"``; ``--layers``
cuts the depth (a multiple of the config's layer group) for a model whose
weights, gradients and optimizer moments outgrow one card at full depth.
The audio encoder ``hubert-xlarge`` trains through the masked-frame loss
(its batches carry frames and a mask; the loss weights are the mask).
Every architecture with a flash backward at its (dk, dv) trains on the
card (``models/model.py::check_card_training``); one with Mamba layers
does not (no SSD gradient).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --batch 8 --seq 128 --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch pixtral-12b \\
      --layers 10 --batch 1 --seq 4096 --steps 8 --ckpt-every 0
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core.controller import resolve_device
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import model as M
from repro_torch.perf import DEFAULT_PERF, replace as perf_replace
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x rolling median (straggler /
    slow-host detection; the elastic driver would re-mesh on repeats)."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                return True
        return False


def run(args) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if args.layers:
        if args.layers % cfg.group_size:
            raise ValueError(f"--layers {args.layers} is no multiple of "
                             f"{cfg.name}'s group of {cfg.group_size}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if torch.device(args.device).type == "cuda":
        M.check_card_training(cfg)
    dev = resolve_device(args.device)
    shape = SHAPES[args.shape]
    perf = perf_replace(DEFAULT_PERF, microbatches=args.microbatches,
                        grad_compress=args.grad_compress,
                        remat="none" if args.reduced else "dots")
    opt_cfg = OptConfig(schedule=cfg.schedule, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5), lr=args.lr)
    step_fn = make_train_step(cfg, perf, opt_cfg)
    data = DataIterator(cfg, shape, seed=args.data_seed, batch=args.batch,
                        seq=args.seq, device=dev)
    mgr = (CheckpointManager(args.ckpt_dir, keep=args.keep,
                             every=args.ckpt_every,
                             async_write=not args.sync_ckpt)
           if args.ckpt_every > 0 else None)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    opt_state = init_train_state(cfg, params, perf)
    start = 0
    restored = (mgr.restore_latest({"params": params, "opt": opt_state})
                if mgr is not None else None)
    if restored is not None:
        start, tree = restored
        params, opt_state = tree["params"], tree["opt"]
        start += 1
        print(f"[train] resumed from step {start - 1}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    dog = StragglerWatchdog()
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = data.at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])      # waits for the step to finish
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_s.append(dt)
        if dog.observe(step, dt):
            print(f"[train] straggler: step {step} took {dt:.2f}s", flush=True)
        if mgr is not None:
            mgr.maybe_save(step, {"params": params, "opt": opt_state})
        if step % args.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms",
                  flush=True)
        if args.crash_at is not None and step == args.crash_at:
            print(f"[train] FAILURE INJECTION at step {step}", flush=True)
            os._exit(42)
    if mgr is not None:
        mgr.maybe_save(args.steps - 1, {"params": params, "opt": opt_state},
                       force=True)
        mgr.finalize()
    report = {
        "arch": args.arch, "steps": args.steps, "device": str(dev),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses, "step_s": step_s,
        "tokens_per_step": args.batch * args.seq,
        "stragglers": dog.flagged,
        "resumed_from": start - 1 if start else None,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
    }
    print(json.dumps(report), flush=True)
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (a multiple of "
                         "the config's layer group); 0 keeps the config's")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between checkpoints; 0 writes none")
    ap.add_argument("--sync-ckpt", action="store_true",
                    help="synchronous checkpoint writes (deterministic "
                         "crash tests)")
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int, default=None)
    return ap.parse_args(argv)


def main() -> int:
    run(parse_args())
    return 0


if __name__ == "__main__":
    sys.exit(main())
