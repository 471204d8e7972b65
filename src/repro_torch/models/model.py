"""Model assembly: embedding -> layer groups -> norm -> head.

Port of ``repro/models/model.py``: the full-sequence ``forward`` and
``loss_fn`` (training, prefill) and ``decode_step`` (serving), with the
parameter and decode-state layouts.  A layer group follows
``cfg.layer_kinds()`` x ``cfg.ffn_kinds()``: GQA attention or a Mamba-2
mixer, an mLSTM or an sLSTM block, with a dense, MoE or no FFN (Jamba: 7
Mamba + 1 attention layer a group, MoE every other layer; xLSTM: 7 mLSTM
+ 1 sLSTM, no FFN).  Parameters keep the JAX package's tree:
``embed.tok`` (and ``embed.head`` when untied), per-position ``groups``
whose leaves are stacked on a leading ``n_groups`` axis, and
``out_norm``.  The decode state is a per-position list of stacked
``{k, v}: (n_groups, B, S_max, Hkv, hd)`` caches (attention), or
recurrent states whose every leaf is ``(n_groups, B, ...)``:
``{conv, h f32}`` (Mamba), ``{C, n, m f32, conv}`` (mLSTM) and
``{c, n, m, h}`` f32 (sLSTM).  The embedding fuses the reference's
frontend stubs: an audio model (``hubert-xlarge``, encoder-only and
bidirectional) embeds precomputed frames through ``embed.frame_proj``
and puts ``embed.mask_emb`` where the batch's mask holds; a vision model
(``pixtral-12b``) replaces its first token positions by patch embeddings
through ``embed.patch_proj`` (early fusion).  An encoder-only model has
no decode step, as in the reference.  MLA is not ported (ROADMAP Queue 1
item 7c.3).

The reference scans the layer groups under ``jax.checkpoint``; here the
groups are a plain loop, each under ``torch.utils.checkpoint`` as
``PerfConfig.remat`` says when a backward will run: ``none``, ``full``
(recompute the whole group in the backward) or ``dots`` (keep the
outputs of the matrix products and recompute the rest, the counterpart
of ``dots_with_no_batch_dims_saveable``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import resolve_device
from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.attention import gqa_decode, gqa_forward
from repro_torch.models.layers import (Leaf, cross_entropy, embed_tokens,
                                       lm_head, mlp, rmsnorm, rope_table)
from repro_torch.perf import DEFAULT_PERF, PerfConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported (ROADMAP Queue 1 item 7c.3)")


def _check_decodes(cfg: ModelConfig) -> None:
    """The reference's refusal of ``decode_step`` (``model.py:208-209``)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")
    _check_ported(cfg)


def check_card_training(cfg: ModelConfig) -> None:
    """Raise where a backward of ``cfg`` on the card would need a gradient
    that no kernel of the port computes yet, before any weight is built."""
    if "mamba" in cfg.layer_kinds():
        raise NotImplementedError(
            f"{cfg.name}: training on the card needs a gradient of the SSD "
            "scan, which the reference's kernel lacks too (ssd_pallas is "
            "forward-only); ROADMAP Queue 1 item 7")
    if "attn" in cfg.layer_kinds() and cfg.head_dim_ not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"{cfg.name}: training on the card needs the flash backward at "
            f"head dim {cfg.head_dim_}, which the port's kernel does not "
            f"take yet (it takes {BWD_HEAD_DIMS}); ROADMAP Queue 2 A1")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _mixer_leaves(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "attn":
        hd = cfg.head_dim_
        return {"wq": Leaf((d, cfg.n_heads * hd)),
                "wk": Leaf((d, cfg.n_kv_heads * hd)),
                "wv": Leaf((d, cfg.n_kv_heads * hd)),
                "wo": Leaf((cfg.n_heads * hd, d), "small")}
    if kind == "mlstm":
        return xlstm.mlstm_leaves(cfg)
    if kind == "slstm":
        return xlstm.slstm_leaves(cfg)
    s, d_in, nh, _ = ssm.dims(cfg)
    return {"in_proj": Leaf((d, 2 * d_in)),
            "conv_w": Leaf((d_in, s.d_conv)),
            "conv_b": Leaf((d_in,), "zeros"),
            "x_to_dt": Leaf((d_in, nh)),
            "dt_bias": Leaf((nh,), "zeros"),
            "x_to_bc": Leaf((d_in, 2 * s.d_state)),
            "a_log": Leaf((nh,), "zeros", f32=True),    # A = -exp(a_log)
            "d_skip": Leaf((nh,), "ones", f32=True),
            "norm": Leaf((d_in,), "ones"),
            "out_proj": Leaf((d_in, d), "small")}


def _ffn_leaves(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "dense":
        return {"w_gate": Leaf((d, cfg.d_ff)), "w_up": Leaf((d, cfg.d_ff)),
                "w_down": Leaf((cfg.d_ff, d), "small")}
    m = cfg.moe
    E, f = m.n_experts, m.d_ff_expert
    out = {"router": Leaf((d, E), f32=True),
           "wg": Leaf((E, d, f)), "wu": Leaf((E, d, f)),
           "wd": Leaf((E, f, d), "small")}
    if m.n_shared:
        fs = f * m.n_shared
        out["shared"] = {"wg": Leaf((d, fs)), "wu": Leaf((d, fs)),
                         "wd": Leaf((fs, d), "small")}
    return out


def param_leaves(cfg: ModelConfig) -> dict:
    """The reference's parameter schema as a tree of ``Leaf``s, group
    leaves stacked on a leading ``n_groups`` axis."""
    _check_ported(cfg)
    d, n = cfg.d_model, cfg.n_groups

    def stacked(tree):
        return tree_map(lambda l: l._replace(shape=(n,) + l.shape), tree,
                        is_leaf=lambda x: isinstance(x, Leaf))

    groups = []
    for kind, ffn in zip(cfg.layer_kinds(), cfg.ffn_kinds()):
        ent = {"ln1": {"scale": Leaf((d,), "ones")},
               "mixer": _mixer_leaves(cfg, kind)}
        if ffn != "none":
            ent["ln2"] = {"scale": Leaf((d,), "ones")}
            ent["ffn"] = _ffn_leaves(cfg, ffn)
        groups.append(stacked(ent))
    embed = {"tok": Leaf((cfg.padded_vocab, d))}
    if cfg.frontend == "vision":
        embed["patch_proj"] = Leaf((d, d))
    if cfg.frontend == "audio":
        embed["frame_proj"] = Leaf((d, d))
        embed["mask_emb"] = Leaf((d,))
    if not cfg.tie_embeddings:
        embed["head"] = Leaf((d, cfg.padded_vocab))
    return {"embed": embed, "groups": groups,
            "out_norm": {"scale": Leaf((d,), "ones")}}


def _is_leaf(x) -> bool:
    return isinstance(x, Leaf)


# the largest row ``init_params`` draws at once (f32 values): a 128-expert
# bank (llama4-maverick, 5.4e9 values a layer) is drawn expert by expert
DRAW_ROW = 1 << 30


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> dict:
    """Random parameters in the reference layout, drawn from ``generator``
    on ``device`` (the card unless the caller asks for the CPU; the
    generator must live there too).  The f32 leaves of the schema
    (``a_log``, ``d_skip``, the MoE router) stay f32.  The draws differ
    from the JAX package's: carry its weights over with
    ``params_from_jax`` where values must agree."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)

    def make(leaf: Leaf):
        dt = torch.float32 if leaf.f32 else dtype
        if leaf.init in ("zeros", "ones"):
            fill = torch.zeros if leaf.init == "zeros" else torch.ones
            return fill(leaf.shape, dtype=dt, device=device)
        scale = 0.002 if leaf.init == "small" else 0.02
        out = torch.empty(leaf.shape, dtype=dt, device=device)
        draw(out, scale)
        return out

    def draw(out, scale):
        # one f32 draw per row at a time; a row of more than DRAW_ROW
        # values (a stacked expert bank) one sub-row at a time
        for i in range(out.shape[0]):
            if out[i].numel() > DRAW_ROW:
                draw(out[i], scale)
            else:
                out[i] = (torch.randn(out.shape[1:], generator=generator,
                                      device=device) * scale).to(out.dtype)

    leaves = param_leaves(cfg)
    # the groups are drawn before the embedding, the order of earlier
    # versions, so a seed keeps giving the same dense weights
    groups = tree_map(make, leaves["groups"], is_leaf=_is_leaf)
    return {"embed": tree_map(make, leaves["embed"], is_leaf=_is_leaf),
            "groups": groups,
            "out_norm": tree_map(make, leaves["out_norm"], is_leaf=_is_leaf)}


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX package's parameter tree (as numpy arrays) as the port's
    parameters on ``device``: the same tree, in the same order, each leaf
    a tensor in the model dtype, or in f32 where the schema keeps it
    f32."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg)

    def conv(node, leaf: Leaf):
        if tuple(node.shape) != leaf.shape:
            raise ValueError(f"leaf of shape {tuple(node.shape)}, the "
                             f"schema has {leaf.shape}")
        host = torch.from_numpy(np.array(node, dtype=np.float32))
        return host.to(device=device,
                       dtype=torch.float32 if leaf.f32 else dtype)
    return tree_map(conv, np_tree, param_leaves(cfg))


def decode_state(cfg: ModelConfig, batch: int, s_max: int, device="cuda",
                 dtype=None) -> list:
    """Zeroed per-position decode states, stacked over groups, on
    ``device``: ``{k, v}`` caches for attention, ``{conv, h}`` (h f32)
    for Mamba, ``{C, n, m, conv}`` (all but conv f32) for mLSTM and
    ``{c, n, m, h}`` (f32) for sLSTM."""
    _check_decodes(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg)
    n = cfg.n_groups
    out = []
    for kind in cfg.layer_kinds():
        if kind == "attn":
            shape = (n, batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
            out.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)})
            continue
        if kind == "mamba":
            s, d_in, nh, dh = ssm.dims(cfg)
            one = {"conv": torch.zeros(batch, s.d_conv - 1, d_in,
                                       dtype=dtype, device=device),
                   "h": torch.zeros(batch, nh, dh, s.d_state,
                                    dtype=torch.float32, device=device)}
        elif kind == "mlstm":
            one = xlstm.mlstm_state(cfg, batch, device, dtype)
        else:
            one = xlstm.slstm_state(cfg, batch, device)
        out.append({k: t.expand(n, *t.shape).contiguous()
                    for k, t in one.items()})
    return out


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _apply_ffn(cfg, ffn_kind, p, x, perf):
    """x plus the layer's FFN, and its MoE aux loss (None without MoE)."""
    if ffn_kind == "none":
        return x, None
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if ffn_kind == "dense":
        return x + mlp(p["ffn"], h), None
    y, aux = moe_mod.moe_forward(cfg, p["ffn"], h, perf=perf)
    return x + y, aux


_MIXER_DECODE = {"mamba": ssm.mamba_decode, "mlstm": xlstm.mlstm_decode,
                 "slstm": xlstm.slstm_decode}


def decode_step(cfg: ModelConfig, params, state, tokens, lengths, *,
                perf: PerfConfig = DEFAULT_PERF, keep=None):
    """One decode step.

    tokens: (B,) int current input token per slot.
    lengths: (B,) int32 tokens already in cache (this token's position).
    keep: None, or a (B,) bool mask of the slots whose recurrent states
    take their new value (the engine's gate).
    Returns (logits (B, V) f32, state).  The state is updated in place:
    each attention layer's cache gains row ``lengths[b]`` for every slot
    ``b``, and each recurrent layer's state takes its new value, only
    where ``keep`` holds when it is given: a slot outside it keeps its
    state bit for bit (the reference's gated ``where``, written without
    a copy of the whole state).
    """
    _check_decodes(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)[:, None]
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    for layer in range(cfg.n_groups):
        for pos, gp in enumerate(params["groups"]):
            p = _layer(gp, layer)
            st = {k: t[layer] for k, t in state[pos].items()}
            hn = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kinds[pos] == "attn":
                y = gqa_decode(cfg, p["mixer"], hn, st, lengths)
            else:
                y, new = _MIXER_DECODE[kinds[pos]](cfg, p["mixer"], hn, st)
                for k, t in new.items():
                    if keep is None:
                        st[k].copy_(t)
                    else:
                        torch.where(keep.view(-1, *(1,) * (t.dim() - 1)),
                                    t.to(st[k].dtype), st[k], out=st[k])
            x = x + y
            x, _ = _apply_ffn(cfg, ffns[pos], p, x, perf)
    x = rmsnorm(params["out_norm"], x, cfg.norm_eps)
    return lm_head(cfg, params["embed"], x)[:, 0], state


def serve_step(cfg: ModelConfig, params, state, tokens, lengths, *,
               perf: PerfConfig = DEFAULT_PERF):
    """Closed serving step: decode, then the greedy next token (int32)."""
    logits, state = decode_step(cfg, params, state, tokens, lengths,
                                perf=perf)
    return logits.argmax(-1).to(torch.int32), state


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


def _project(x, w):
    """``x @ w`` in the promoted dtype of the two, as the reference's
    einsum of f32 frames or patches with a bf16 weight (f32 out)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _embed(cfg: ModelConfig, params, batch):
    """Token / frontend embedding fusion -> (B, S, d) activations (port of
    ``repro/models/model.py::_embed``).  Audio: ``frames @ frame_proj``,
    ``mask_emb`` where ``mask`` holds, then the model dtype (the select
    in the promoted dtype, the cast last).  Vision: the first ``n``
    positions of the token embedding replaced by ``patches @
    patch_proj`` in the model dtype."""
    p = params["embed"]
    if cfg.frontend == "audio":
        x = _project(batch["frames"], p["frame_proj"])
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None],
                            p["mask_emb"].to(x.dtype)[None, None], x)
        return x.to(torch_dtype(cfg))
    x = embed_tokens(cfg, p, batch["tokens"])
    if cfg.frontend == "vision" and "patches" in batch:
        pe = _project(batch["patches"], p["patch_proj"])
        x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
    return x


_MIXER_FORWARD = {"mamba": ssm.mamba_forward, "mlstm": xlstm.mlstm_forward,
                  "slstm": xlstm.slstm_forward}


def forward(cfg: ModelConfig, params, batch, *,
            perf: PerfConfig = DEFAULT_PERF, causal=None):
    """Full-sequence forward -> (logits (B,S,V) f32, aux loss scalar f32,
    the MoE load-balance losses summed over layers)."""
    _check_ported(cfg)
    causal = (not cfg.encoder_only) if causal is None else causal
    x = _embed(cfg, params, batch)
    S = x.shape[1]
    cos, sin = (rope_table(S, cfg.head_dim_, cfg.rope_theta, device=x.device)
                if cfg.rope_theta else (None, None))
    per_pos = [_unstack(gp, cfg.n_groups) for gp in params["groups"]]
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()

    def group_body(h, *group):
        aux = None                       # the group's MoE aux losses
        for kind, ffn, p in zip(kinds, ffns, group):
            hn = rmsnorm(p["ln1"], h, cfg.norm_eps)
            if kind == "attn":
                h = h + gqa_forward(cfg, p["mixer"], hn, cos, sin,
                                    causal=causal)
            else:
                h = h + _MIXER_FORWARD[kind](cfg, p["mixer"], hn, perf=perf)
            h, a = _apply_ffn(cfg, ffn, p, h, perf)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    # remat only matters where a backward will run (not under
    # torch.no_grad or inference_mode, as in a prefill)
    body = (_remat(group_body, perf.remat) if torch.is_grad_enabled()
            else group_body)
    auxs = []
    for i in range(cfg.n_groups):
        x, aux = body(x, *(pos[i] for pos in per_pos))
        if aux is not None:
            auxs.append(aux)
    x = rmsnorm(params["out_norm"], x, cfg.norm_eps)
    logits = lm_head(cfg, params["embed"], x)
    return logits, (torch.stack(auxs).sum() if auxs else torch.zeros(
        (), dtype=torch.float32, device=x.device))


def loss_fn(cfg: ModelConfig, params, batch, *,
            perf: PerfConfig = DEFAULT_PERF):
    """Scalar loss + metrics.  batch: tokens (or an audio model's frames
    and mask; a vision model's patches too), labels, weights (an audio
    model's mask: the masked-frame loss)."""
    logits, aux = forward(cfg, params, batch, perf=perf)
    ce = cross_entropy(logits, batch["labels"], batch["weights"].float())
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}
