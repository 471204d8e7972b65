"""Plain torch oracles for the port's kernels (``repro/kernels/ref.py``).

Only the decode-attention oracle is ported in this slice; the flash
forward/backward, paged decode, SSD and mLSTM oracles come with their
kernels (ROADMAP Queue 2).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         scale: Optional[float] = None,
                         block_s: int = 2048):
    """Single-token decode vs a contiguous cache, flash-decoding style —
    the reference's block loop with a running (max, sum, acc).

    q:(B,H,dk) k_cache:(B,Smax,Hkv,dk) v_cache:(B,Smax,Hkv,dv) lengths:(B,)
    Attends to positions < lengths[b].  As in the reference, q (scaled
    in f32) and the probabilities are cast to the cache dtype before
    their products, which accumulate in f32.
    """
    B, Smax, hkv, dk = k_cache.shape
    scale = scale or dk ** -0.5
    H = q.shape[1]
    g = H // hkv
    dv = v_cache.shape[-1]
    bs = min(block_s, Smax)
    if Smax % bs:
        raise ValueError(f"S_max {Smax} is not a multiple of block {bs}")
    qg = (q.reshape(B, hkv, g, dk).float() * scale).to(k_cache.dtype)
    acc = torch.zeros(B, hkv, g, dv, dtype=torch.float32, device=q.device)
    m = torch.full((B, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, hkv, g, dtype=torch.float32, device=q.device)
    for i in range(Smax // bs):
        kb = k_cache[:, i * bs:(i + 1) * bs]
        vb = v_cache[:, i * bs:(i + 1) * bs]
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kb.float())
        pos = i * bs + torch.arange(bs, device=q.device)
        mask = (pos[None] < lengths[:, None])[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgs,bske->bkge", p.to(v_cache.dtype).float(), vb.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, dv).to(q.dtype)
