"""Token sampling for the serving engine (``repro/serving/sampling.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V) f32 -> (B,) int32.

    temperature == 0 -> greedy (first maximum, as ``jnp.argmax``);
    otherwise a draw from ``generator``, restricted to the ``top_k`` best
    when ``top_k > 0``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
