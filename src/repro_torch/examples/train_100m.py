"""Train a ~100M-parameter llama-family model for a few hundred steps,
with checkpoints, the cosine schedule and optional gradient compression
— the end-to-end training driver at example scale (port of
``examples/train_100m.py``).

It runs on the card unless ``--device cpu`` is given: f32 throughout,
the flash kernels at head dim 64; ``--grad-compress`` quantizes each
gradient to int8 with error feedback before the update.  Checkpoints
(params and optimizer state, every 100 steps, the newest 2 kept) go to
``--ckpt-dir``, by default ``build/train100m`` under the checkout.

Run: PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]
(~100M params is slow on the CPU; --d-model 256 gives a quick demo run.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.controller import resolve_device
from repro_torch.data.pipeline import DataIterator
from repro_torch.models import model as M
from repro_torch.perf import DEFAULT_PERF, replace as perf_replace
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train100m"
CKPT_EVERY, CKPT_KEEP = 100, 2     # steps between checkpoints, kept


def build_cfg(d_model: int, n_layers: int):
    base = get_config("llama3.2-3b")
    return dataclasses.replace(
        base, n_layers=n_layers, d_model=d_model, n_heads=max(d_model // 64, 2),
        n_kv_heads=max(d_model // 128, 1), d_ff=d_model * 4, vocab=8192,
        head_dim=64, dtype="float32", group_size=1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def trainer(args, dev, params=None) -> tuple:
    """What the run trains with: (params, optimizer state, the train
    step, the data).  ``params`` is drawn from a generator seeded with 0
    on ``dev`` when not given."""
    cfg = build_cfg(args.d_model, args.layers)
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(0), device=dev)
    perf = perf_replace(DEFAULT_PERF, remat="none",
                        grad_compress=args.grad_compress)
    opt_cfg = OptConfig(lr=6e-4, warmup_steps=args.steps // 20,
                        total_steps=args.steps)
    step_fn = make_train_step(cfg, perf, opt_cfg)
    opt = init_train_state(cfg, params, perf)
    data = DataIterator(cfg, SHAPES["train_4k"], seed=0,
                        batch=args.batch, seq=args.seq, device=dev)
    return params, opt, step_fn, data


def main(argv=None, params=None) -> dict:
    """Train and print the source's lines; returns the parameter count,
    every step's loss and learning rate, the tokens a second of each
    logged line, the seconds, the peak device memory (the card's, else
    None) and the checkpoint manager.  ``params``: the model's weights
    on the device (``trainer``)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_cfg(args.d_model, args.layers)
    n = cfg.param_count()
    print(f"model: {n / 1e6:.1f}M params, {cfg.n_layers}L x {cfg.d_model}")
    params, opt, step_fn, data = trainer(args, dev, params)
    mgr = CheckpointManager(args.ckpt_dir, keep=CKPT_KEEP, every=CKPT_EVERY)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    tokens = 0
    metrics, tok_s = [], {}
    for i in range(args.steps):
        params, opt, m = step_fn(params, opt, data.at(i), i)
        tokens += args.batch * args.seq
        # read on the logged steps only: the host runs ahead in between
        metrics.append((m["loss"], m["lr"]))
        mgr.maybe_save(i, {"params": params, "opt": opt})
        if i % 20 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            tok_s[i] = tokens / max(dt, 1e-9)
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  {tok_s[i]:,.0f} tok/s")
    mgr.finalize()
    seconds = time.time() - t0
    print(f"done: final loss {float(m['loss']):.4f} "
          f"({seconds:.0f}s); checkpoints in {args.ckpt_dir}")
    return {"params": n, "losses": [float(x) for x, _ in metrics],
            "lrs": [float(x) for _, x in metrics], "tokens_per_s": tok_s,
            "seconds": seconds,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                               if dev.type == "cuda" else None),
            "manager": mgr}


if __name__ == "__main__":
    main()
