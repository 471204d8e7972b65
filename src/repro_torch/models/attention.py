"""Attention mixers, GQA and MLA (DeepSeek-V2): full sequence and decode
(port of ``repro/models/attention.py``).

GQA projections keep the reference's flattened ``(d, H*hd)`` layout, MLA
its stacked ``(rank, H, width)`` ones.  The full-sequence forms run the
hand-written flash kernels (MLA at dk 192 / dv 128); the decode forms
write the per-slot cache in place at row ``lengths[b]`` (the reference
returns an updated copy): ``{k, v}: (B, S_max, Hkv, hd)`` for GQA,
decoded by the decode kernel, and the latent ``{ckv: (B, S_max, L),
krope: (B, S_max, rd)}`` for MLA, decoded by the latent decode kernel
in bf16 and in torch in f32, as the reference's lax code does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.mla_decode import mla_decode_plain
from repro_torch.models.layers import (apply_rope, rmsnorm, rope_table,
                                       yarn_mscale)
from repro_torch.tracing import span


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


# ====================================================================== MLA


def _rms(x, scale, eps):
    """The reference's ``_rms``: RMSNorm in f32, cast back to x's dtype."""
    return rmsnorm({"scale": scale}, x, eps)


def _proj(x, w):
    """x (..., n) @ w (n, *out) -> (..., *out): one 2-D product (the
    reference's einsums over a stacked weight)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: dk ** -0.5, times YaRN's mscale(factor,
    mscale_all_dim) squared where the rope is YaRN-scaled and that mscale
    is given (DeepSeek-V2's ``softmax_scale``)."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    y = m.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_q(cfg: ModelConfig, p, x, cos, sin):
    """Shared q path -> (q_nope (B,S,H,nd), q_rope (B,S,H,rd))."""
    m = cfg.mla
    ql = _rms(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = _proj(ql, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], cos, sin)
    return q_nope, q_rope


def mla_forward(cfg: ModelConfig, p, x, cos, sin, *, causal: bool = True):
    """Prefill/train MLA (``attention.py:144-167`` of the reference): the
    latent expanded to per-head K/V, k_rope broadcast over the heads, the
    flash kernels at dk = nope + rope (192) and dv (128), scale
    ``mla_scale``.  x: (B, S, d) -> (B, S, d); cos/sin: (S, rd/2)."""
    m = cfg.mla
    B, S, _ = x.shape
    H, L = cfg.n_heads, m.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x, cos, sin)
    dkv = x @ p["w_dkv"]
    ckv = _rms(dkv[..., :L], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, L:], cos, sin)      # (B, S, 1, rd)
    k_nope = _proj(ckv, p["w_uk"])
    v = _proj(ckv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    o = ops.flash_attention(q, k, v.contiguous(), causal=causal,
                            scale=mla_scale(cfg))
    return o.reshape(B, S, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])


def mla_decode(cfg: ModelConfig, p, x, cache, lengths):
    """Absorbed-matrices MLA decode against the latent cache
    (``attention.py:179-245`` of the reference): W_UK is absorbed into q and
    W_UV into the output, so the latent ``{ckv (B,S_max,L), krope
    (B,S_max,rd)}`` is attended directly under an f32 online softmax,
    products of the cache's dtype accumulated in f32 (the span
    ``mla.latent_decode``).  The reference's code is lax, not a kernel: a
    bf16 cache (the serving path) takes ``ops.mla_decode``, the kernel on
    a card, and an f32 one (the parity path) its plain torch version on
    every device.  Writes this token's latent row ``lengths[b]`` in place
    and returns out (B, 1, d)."""
    m = cfg.mla
    B = x.shape[0]
    H, L = cfg.n_heads, m.kv_lora_rank
    cos, sin = rope_table(1, m.qk_rope_head_dim, cfg.rope_theta,
                          positions=lengths[:, None], yarn=m.rope_scaling)
    q_nope, q_rope = _mla_q(cfg, p, x, cos, sin)          # (B, 1, H, *)
    dkv = x @ p["w_dkv"]
    ckv_new = _rms(dkv[..., :L], p["kv_norm"], cfg.norm_eps)
    krope_new = apply_rope(dkv[..., None, L:], cos, sin)[:, :, 0]
    ckv, krope = cache["ckv"], cache["krope"]
    bidx = torch.arange(B, device=x.device)
    rows = lengths.long()
    ckv[bidx, rows] = ckv_new[:, 0].to(ckv.dtype)
    krope[bidx, rows] = krope_new[:, 0].to(krope.dtype)

    with span("mla.latent_decode"):
        o_lat = _latent_attend(q_nope, q_rope, p["w_uk"], ckv, krope,
                               lengths, mla_scale(cfg))
    o = torch.einsum("bhl,lhv->bhv", o_lat.float(),
                     p["w_uv"].float()).to(x.dtype)
    return (o.reshape(B, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1]))[:, None]


def _latent_attend(q_nope, q_rope, w_uk, ckv, krope, lengths, scale):
    """The absorbed attention over the latent rows: q_nope through W_UK
    into the latent space, both parts of q scaled and rounded to the
    cache's dtype, then softmax(q_abs c_kv + q_rope k_rope) over each
    slot's live rows; the latent output (B, H, L) in q's dtype."""
    q_abs = torch.einsum("bhk,lhk->bhl", q_nope[:, 0], w_uk)
    qf = (q_abs * scale).to(ckv.dtype).contiguous()
    qr = (q_rope[:, 0] * scale).to(krope.dtype).contiguous()
    live = (lengths + 1).to(torch.int32)
    attend = (ops.mla_decode if ckv.dtype == torch.bfloat16
              else mla_decode_plain)
    return attend(qf, qr, ckv, krope, live).to(q_nope.dtype)


# ================================================================ dispatch


def attn_forward(cfg: ModelConfig, p, x, cos, sin, *, causal: bool = True):
    fn = mla_forward if cfg.mla is not None else gqa_forward
    return fn(cfg, p, x, cos, sin, causal=causal)


def attn_decode(cfg: ModelConfig, p, x, cache, lengths):
    fn = mla_decode if cfg.mla is not None else gqa_decode
    return fn(cfg, p, x, cache, lengths)
