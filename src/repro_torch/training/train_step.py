"""Training step: CE loss + AdamW, with microbatching (gradient
accumulation), optional int8 gradient compression with error feedback,
and remat inside the model's layer groups (port of
``repro/training/train_step.py``).

``make_train_step(cfg, perf, opt_cfg)`` returns
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``.
Parameters and optimizer state are updated in place; the returned trees
are the ones passed in.  With ``microbatches > 1`` the gradients are
summed in f32 and divided, as the reference's ``lax.scan`` does; with
one microbatch they keep the parameters' dtype.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_structure, tree_unflatten

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.perf import DEFAULT_PERF, PerfConfig
from repro_torch.training import compression
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_opt_state, make_schedule)


def init_train_state(cfg: ModelConfig, params,
                     perf: PerfConfig = DEFAULT_PERF) -> dict:
    st = init_opt_state(params)
    if perf.grad_compress:
        st["err_fb"] = compression.init_error_feedback(params)
    return st


def _split_microbatches(batch: dict, k: int) -> list:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    return [{key: v[i * (b // k):(i + 1) * (b // k)]
             for key, v in batch.items()} for i in range(k)]


def make_train_step(cfg: ModelConfig, perf: PerfConfig = DEFAULT_PERF,
                    opt_cfg: OptConfig = OptConfig()) -> Callable:
    sched = make_schedule(opt_cfg)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def value_and_grad(b):
            loss, metrics = M.loss_fn(cfg, params, b, perf=perf)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), metrics, grads

        if perf.microbatches <= 1:
            loss, metrics, grads = value_and_grad(batch)
        else:
            acc, total = None, 0.0
            for micro in _split_microbatches(batch, perf.microbatches):
                loss, _, grads = value_and_grad(micro)
                grads = [g.float() for g in grads]
                acc = grads if acc is None else [
                    a + g for a, g in zip(acc, grads)]
                total = total + loss
            k = float(perf.microbatches)
            grads = [g / k for g in acc]
            loss = total / k
            metrics = {"loss": loss}
        return loss, metrics, tree_unflatten(list(grads),
                                             tree_structure(params))

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = grads_of(params, batch)
        if perf.grad_compress:
            grads, new_err = compression.quantize_with_feedback(
                grads, opt_state["err_fb"])
        lr = sched(step)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                lr, opt_cfg)
        if perf.grad_compress:
            opt_state["err_fb"] = new_err
        out = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        if "ce" in metrics:
            out["ce"] = metrics["ce"].detach()
        return params, opt_state, out

    return train_step
