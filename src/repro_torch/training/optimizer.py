"""Optimizer and LR schedules (port of ``repro/training/optimizer.py``).

AdamW with decoupled weight decay; schedules: linear-warmup cosine and
WSD (warmup-stable-decay).  The moments are f32 and mirror the parameter
tree leaf for leaf; parameters keep their storage dtype.  Unlike the
reference, which returns new trees, ``adamw_update`` updates parameters
and moments in place under ``torch.no_grad()``: at full width a second
copy of 3.2 B parameters and 25.7 GB of moments would not fit beside the
first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | wsd
    wsd_stable_frac: float = 0.8      # fraction of post-warmup steps at peak
    min_lr_frac: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def make_schedule(cfg: OptConfig) -> Callable:
    """step -> learning rate, an f32 scalar tensor computed as the
    reference computes it in f32."""
    def sched(step):
        step = _f32(step)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "cosine":
            t = torch.clamp((step - cfg.warmup_steps)
                            / max(cfg.total_steps - cfg.warmup_steps, 1),
                            0.0, 1.0)
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(_f32(math.pi) * t))
        elif cfg.schedule == "wsd":
            stable_end = (cfg.warmup_steps + cfg.wsd_stable_frac
                          * (cfg.total_steps - cfg.warmup_steps))
            t = torch.clamp((step - stable_end)
                            / max(cfg.total_steps - stable_end, 1), 0.0, 1.0)
            # MiniCPM's decay phase: exponential-ish fast anneal
            decay = _f32(cfg.min_lr_frac) ** t
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * warm * decay
    return sched


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, summed in f32."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr, cfg: OptConfig):
    """One AdamW step, in place: ``params`` (storage dtype) and the f32
    moments of ``opt_state`` are overwritten.  Returns (params,
    opt_state, grad norm)."""
    count = opt_state["count"] + 1
    b1, b2 = cfg.betas
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=count.device), count)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=count.device), count)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, gnorm
