"""Shared pieces of the plain references: float32 arithmetic, a float8
control, RMSNorm, rotary positions, causal attention in row blocks.

The references compute in float32 with TF32 switched off.  The control
of the comparisons computes every weight product in float8 (e4m3, one
scale a tensor for the weight and one for the activations), the
precision below the configurations' bfloat16, everything else as the
reference does.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "float8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor
    (its largest magnitude maps to 448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """A layer's weights as the reference multiplies with them: float32
    copies of the bfloat16 (or float32) leaves, or their float8
    roundings for the control."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of "
                             f"{PRECISIONS}")
        self.precision = precision

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return to_e4m3(t) if self.precision == "float8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` with ``w`` as returned by ``self.w``."""
        if self.precision == "float8":
            x = to_e4m3(x)
        return x @ w


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def swiglu(x, wg, wu, wd, W: Weights):
    return W.mm(F.silu(W.mm(x, wg)) * W.mm(x, wu), wd)


def rope(x, positions, theta: float):
    """Rotary positions on x (L, H, hd), rotating its two halves, the
    angle of pair i at position p being p * theta ** (-i / (hd / 2))."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = positions.double()[:, None] * inv[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, *, block: int = 512):
    """softmax(q k^T / sqrt(hd)) v under a causal mask, grouped query
    heads sharing their kv head; q (L, H, hd), k and v (L, Hkv, hd),
    in blocks of query rows, each against the keys up to its end."""
    L, H, hd = q.shape
    g = H // k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    kh = k.permute(1, 0, 2).repeat_interleave(g, 0)      # (H, L, hd)
    vh = v.permute(1, 0, 2).repeat_interleave(g, 0)
    for r0 in range(0, L, block):
        r1 = min(L, r0 + block)
        qb = q[r0:r1].permute(1, 0, 2)                   # (H, b, hd)
        s = (qb @ kh[:, :r1].transpose(1, 2)) * scale    # (H, b, r1)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[r0:r1] = (p @ vh[:, :r1]).permute(1, 0, 2)
    return out
