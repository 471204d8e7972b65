"""Model assembly: embedding -> layer groups -> norm -> head.

Port of the dense part of ``repro/models/model.py``: the full-sequence
``forward`` and ``loss_fn`` (training) and ``decode_step`` (serving),
with the parameter and decode-state layouts.  Parameters keep the JAX
package's tree: ``embed.tok``, per-position ``groups`` whose leaves are
stacked on a leading ``n_groups`` axis, and ``out_norm``; the decode
state is a per-position list of ``{k, v}: (n_groups, B, S_max, Hkv, hd)``
caches.  Only attention mixers with dense FFNs are ported (ROADMAP
Queue 1 item 7 lists the other families).

The reference scans the layer groups under ``jax.checkpoint``; here the
groups are a plain loop, each under ``torch.utils.checkpoint`` as
``PerfConfig.remat`` says: ``none``, ``full`` (recompute the whole group
in the backward) or ``dots`` (keep the outputs of the matrix products
and recompute the rest, the counterpart of
``dots_with_no_batch_dims_saveable``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import resolve_device
from repro_torch.models.attention import gqa_decode, gqa_forward
from repro_torch.models.layers import (cross_entropy, embed_tokens, lm_head,
                                       mlp, rmsnorm, rope_table)
from repro_torch.perf import DEFAULT_PERF, PerfConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    if set(cfg.layer_kinds()) != {"attn"} or cfg.mla is not None \
            or set(cfg.ffn_kinds()) - {"dense"}:
        raise NotImplementedError(
            f"{cfg.name}: the port decodes dense GQA models only (ROADMAP "
            "Queue 1 item 7)")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _group_shapes(cfg: ModelConfig) -> dict:
    d, hd, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    return {
        "ln1": {"scale": (d,)},
        "mixer": {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                  "wv": (d, cfg.n_kv_heads * hd),
                  "wo": (cfg.n_heads * hd, d)},
        "ln2": {"scale": (d,)},
        "ffn": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)},
    }


# initializer scales of the reference schema: normal 0.02, "small" leaves
# (the output projections) 0.002, norm scales ones
_SMALL = {"wo", "w_down"}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> dict:
    """Random parameters in the reference layout, drawn from ``generator``
    on ``device`` (the card unless the caller asks for the CPU; the
    generator must live there too).  The draws differ from the JAX
    package's: carry its weights over with ``params_from_jax`` where
    values must agree."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    n = cfg.n_groups

    def normal(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):       # one f32 draw per layer at a time
            out[i] = (torch.randn(shape[1:], generator=generator,
                                  device=device) * scale).to(dtype)
        return out

    groups = []
    for _ in cfg.layer_kinds():
        g = {}
        for mod, leaves in _group_shapes(cfg).items():
            g[mod] = {}
            for name, shape in leaves.items():
                if name == "scale":
                    g[mod][name] = torch.ones((n,) + shape, dtype=dtype,
                                              device=device)
                else:
                    g[mod][name] = normal(
                        (n,) + shape, 0.002 if name in _SMALL else 0.02)
        groups.append(g)
    tok = normal((cfg.padded_vocab, cfg.d_model), 0.02)
    embed = {"tok": tok}
    if not cfg.tie_embeddings:
        embed["head"] = normal((cfg.d_model, cfg.padded_vocab), 0.02)
    return {"embed": embed, "groups": groups,
            "out_norm": {"scale": torch.ones(cfg.d_model, dtype=dtype,
                                             device=device)}}


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX package's parameter tree (as numpy arrays) as the port's
    parameters on ``device``: the same tree, each leaf a tensor in the
    model dtype."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        host = torch.from_numpy(np.array(node, dtype=np.float32))
        return host.to(device=device, dtype=dtype)
    return conv(np_tree)


def decode_state(cfg: ModelConfig, batch: int, s_max: int, device="cuda",
                 dtype=None) -> list:
    """Zeroed per-position ``{k, v}`` caches, stacked over groups, on
    ``device``."""
    _check_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    shape = (cfg.n_groups, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in cfg.layer_kinds()]


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def decode_step(cfg: ModelConfig, params, state, tokens, lengths):
    """One decode step.

    tokens: (B,) int current input token per slot.
    lengths: (B,) int32 tokens already in cache (this token's position).
    Returns (logits (B, V) f32, state).  The state is updated in place:
    each layer's cache gains row ``lengths[b]`` for every slot ``b``.
    """
    _check_ported(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)[:, None]
    for layer in range(cfg.n_groups):
        for pos, gp in enumerate(params["groups"]):
            p = _layer(gp, layer)
            cache = {"k": state[pos]["k"][layer], "v": state[pos]["v"][layer]}
            hn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            x = x + gqa_decode(cfg, p["mixer"], hn, cache, lengths)
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps))
    x = rmsnorm(params["out_norm"], x, cfg.norm_eps)
    return lm_head(cfg, params["embed"], x)[:, 0], state


# ------------------------------------------------------------- forward

# the matrix products whose outputs ``remat="dots"`` keeps: those with no
# batch dimension, as ``dots_with_no_batch_dims_saveable`` (the flash
# kernel's own products are inside its Function and recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat policy {remat!r}")


def _unstack(tree, n: int) -> list:
    """The stacked leaves as ``n`` per-group trees of views, by one
    ``unbind`` per leaf, whose backward stacks the group gradients once."""
    out = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = (_unstack(val, n) if isinstance(val, dict)
                 else val.unbind(0))
        for i in range(n):
            out[i][key] = parts[i]
    return out


def forward(cfg: ModelConfig, params, batch, *,
            perf: PerfConfig = DEFAULT_PERF, causal=None):
    """Full-sequence forward -> (logits (B,S,V) f32, aux loss scalar)."""
    _check_ported(cfg)
    causal = (not cfg.encoder_only) if causal is None else causal
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    S = x.shape[1]
    cos, sin = (rope_table(S, cfg.head_dim_, cfg.rope_theta, device=x.device)
                if cfg.rope_theta else (None, None))
    per_pos = [_unstack(gp, cfg.n_groups) for gp in params["groups"]]

    def group_body(h, *group):
        for p in group:
            hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
            h = h + gqa_forward(cfg, p["mixer"], hn, cos, sin, causal=causal)
            h = h + mlp(p["ffn"], rmsnorm(p["ln2"], h, cfg.norm_eps))
        return h

    body = _remat(group_body, perf.remat)
    for i in range(cfg.n_groups):
        x = body(x, *(pos[i] for pos in per_pos))
    x = rmsnorm(params["out_norm"], x, cfg.norm_eps)
    logits = lm_head(cfg, params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, *,
            perf: PerfConfig = DEFAULT_PERF):
    """Scalar loss + metrics.  batch: tokens, labels, weights."""
    logits, aux = forward(cfg, params, batch, perf=perf)
    ce = cross_entropy(logits, batch["labels"], batch["weights"].float())
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}
