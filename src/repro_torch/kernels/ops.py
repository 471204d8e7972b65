"""Dispatch for the compute hot spots (``repro/kernels/ops.py``).

The reference picks an implementation per call (``impl=``, Pallas on a
TPU, blockwise elsewhere).  The port has one entry per op whose kernel
wrapper decides by the tensors' device: the hand-written CUDA kernel for
CUDA tensors, the plain torch version for CPU tensors.  The one-token
SSD step has no kernel in the reference either: it is plain torch code.
Nor has the mLSTM: the reference's "pallas" route for it is the lax
``ref.mlstm_chunked`` (``repro/kernels/ops.py:114-128``), no Pallas
kernel, so ``mlstm`` and ``mlstm_decode`` are ports of lax code and run
as torch on every device, the card included.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _ssd
from repro_torch.kernels import mla_decode as _mla
from repro_torch.kernels import ref


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """Dense-cache single-token decode (flash-decoding split over S)."""
    return _decode.decode_attention(q, k_cache, v_cache, lengths,
                                    scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: Optional[float] = None):
    """Paged-pool single-token decode (no caller in the engine yet)."""
    return _decode.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          lengths, scale=scale)


def mla_decode(q_lat, q_rope, ckv, krope, lengths):
    """Absorbed MLA decode over a latent cache (no kernel in the
    reference, whose decode is lax: the card's bf16 serving path)."""
    return _mla.mla_decode(q_lat, q_rope, ckv, krope, lengths)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Full-sequence attention (train / prefill), differentiable: the
    hand-written flash forward and two-pass backward."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


def ssd(x, dt, A, B, C, D, *, chunk: int = 256, h0=None):
    """The full-sequence SSD scan -> (y, h_final f32)."""
    return _ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk, h0=h0)


def ssd_decode(h, x, dt, A, B, C, D):
    """One-token SSD update -> (y, h_new f32)."""
    return ref.ssd_decode_step(h, x, dt, A, B, C, D)


def mlstm(q, k, v, i_gate, f_gate, *, chunk: int = 256, state=None):
    """The full-sequence mLSTM, chunk-parallel (torch on every device)
    -> (y, (C, n, m) f32)."""
    return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk,
                             state=state)


def mlstm_decode(state, q, k, v, i_gate, f_gate):
    """One-token mLSTM update -> (y, (C, n, m) f32)."""
    return ref.mlstm_decode_step(state, q, k, v, i_gate, f_gate)
