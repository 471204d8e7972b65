"""GQA attention: full sequence and decode (port of
``repro/models/attention.py:47-107``).

Projections keep the reference's flattened ``(d, H*hd)`` layout.  The
full-sequence form runs the hand-written flash kernels; the decode form
writes the per-slot cache ``{k, v}: (B, S_max, Hkv, hd)`` in place at
row ``lengths[b]`` (the reference returns an updated copy).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rope_table


def _heads(t, hd):
    return t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd)


def gqa_forward(cfg: ModelConfig, p, x, cos, sin, *, causal: bool = True):
    """x: (B, S, d) -> (B, S, d); cos/sin: (S, hd/2) RoPE tables."""
    hd = cfg.head_dim_
    q = _heads(x @ p["wq"], hd)                 # (B, S, H, hd)
    k = _heads(x @ p["wk"], hd)
    v = _heads(x @ p["wv"], hd)
    if cfg.rope_theta:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    return o.reshape(*x.shape[:2], -1) @ p["wo"]


def gqa_decode(cfg: ModelConfig, p, x, cache, lengths):
    """x: (B, 1, d); cache {k,v}: (B, S_max, Hkv, hd); lengths: (B,) i32
    tokens already cached.  Writes this token's k/v into the cache in
    place and returns out (B, 1, d)."""
    B = x.shape[0]
    hd = cfg.head_dim_
    q = _heads(x @ p["wq"], hd)                 # (B, 1, H, hd)
    k = _heads(x @ p["wk"], hd)
    v = _heads(x @ p["wv"], hd)
    if cfg.rope_theta:
        cos, sin = rope_table(1, hd, cfg.rope_theta,
                              positions=lengths[:, None])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    rows = lengths.long()
    cache["k"][bidx, rows] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, rows] = v[:, 0].to(cache["v"].dtype)
    o = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                             lengths + 1)
    return (o.reshape(B, -1) @ p["wo"])[:, None]
