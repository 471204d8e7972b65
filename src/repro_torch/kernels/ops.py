"""Dispatch for the compute hot spots (``repro/kernels/ops.py``).

The reference picks an implementation per call (``impl=``, Pallas on a
TPU, blockwise elsewhere).  The port has one entry per op whose kernel
wrapper decides by the tensors' device: the hand-written CUDA kernel for
CUDA tensors, the plain torch version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """Dense-cache single-token decode (flash-decoding split over S)."""
    return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                    scale=scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Full-sequence attention (train / prefill), differentiable: the
    hand-written flash forward and two-pass backward."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
