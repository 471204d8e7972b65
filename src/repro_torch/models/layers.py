"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embedding, LM head, the
cross-entropy loss, and ``Leaf``, one parameter of the schema.

Port of ``repro/models/layers.py``.  The matrix products the JAX package
leaves to XLA stay plain ``@`` products here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


class Leaf(NamedTuple):
    """One parameter of the reference schema: its shape, its initializer
    (normal: std 0.02; small: 0.002; zeros; ones) and whether it stays
    f32 whatever the model dtype."""
    shape: tuple
    init: str = "normal"
    f32: bool = False


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale: 0.1 mscale ln(factor) + 1 (1 at factor <=
    1), as DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_bounds(yarn, dim: int, theta: float) -> tuple:
    """The first and last rotary pair of YaRN's ramp: the dimensions
    whose rotations at the original context lie between beta_fast and
    beta_slow (``yarn_find_correction_range``)."""
    def at(rot):
        return (dim * math.log(yarn.original_max_position_embeddings
                               / (rot * 2 * math.pi))) / (2 * math.log(theta))
    low = max(math.floor(at(yarn.beta_fast)), 0)
    high = min(math.ceil(at(yarn.beta_slow)), dim - 1)
    return low, (high + 0.001 if low == high else high)


def rope_table(seq_len: int, head_dim: int, theta: float, positions=None,
               device=None, yarn=None):
    """(S, hd/2) cos/sin tables in f32; ``positions`` overrides arange.
    ``yarn`` (a ``YarnConfig``) blends each pair's frequency between the
    base one and the base one over ``yarn.factor`` by YaRN's ramp and
    scales cos/sin by the ratio of its two mscales."""
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        positions = positions.float()
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    # a Python-float base: a device tensor built from ``theta`` here
    # would be a host-to-device copy, which waits for the stream
    freqs = theta ** (-idx / half)
    if yarn is not None:
        low, high = _yarn_bounds(yarn, head_dim, theta)
        extra = 1.0 - torch.clamp((idx - low) / (high - low), 0, 1)
        freqs = freqs / yarn.factor * (1 - extra) + freqs * extra
    ang = positions[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    return cos, sin


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def mlp(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def embed_tokens(cfg: ModelConfig, p, tokens):
    """Clip gather, as the reference's ``.at[tokens].get(mode="clip")``."""
    return p["tok"][torch.clamp(tokens, 0, p["tok"].shape[0] - 1).long()]


def lm_head(cfg: ModelConfig, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (x @ w).float()


def cross_entropy(logits, labels, weights):
    """Mean CE over weighted positions, logits f32 (B, S, V) over the
    padded vocab, plus the reference's 1e-4 z-loss.  The gold logit comes
    from a one-hot mask, as in the reference (``layers.py:111-124``)."""
    logz = torch.logsumexp(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    gold = (logits * onehot).sum(-1)
    nll = (logz - gold) * weights
    denom = torch.clamp(weights.sum(), min=1.0)
    # small z-loss for stability (MaxText-style)
    zloss = 1e-4 * (logz * weights) ** 2
    return (nll.sum() + zloss.sum()) / denom
