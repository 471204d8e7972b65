"""Gradient compression: int8 quantization with error feedback (port of
``repro/training/compression.py``).

Per-leaf symmetric int8 quantization, the residual carried in an f32
error-feedback buffer so compression error does not accumulate.  The
all-reduce that moves the int8 payload between data-parallel replicas
(``compressed_psum``) needs more than one card and is not ported yet
(ROADMAP Queue 1 item 8); on one card the trainer quantizes and
dequantizes in place of it.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)


def quantize_leaf(g, err):
    """Symmetric int8 quantization with error feedback.  Returns
    (dequantized g_hat in g's dtype, new f32 error buffer)."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat.to(g.dtype), gf - g_hat


def quantize_with_feedback(grads, err_tree):
    """(dequantized grads, new error buffers), tree for tree."""
    leaves, spec = tree_flatten(grads)
    pairs = [quantize_leaf(g, e)
             for g, e in zip(leaves, tree_leaves(err_tree))]
    return (tree_unflatten([g for g, _ in pairs], spec),
            tree_unflatten([e for _, e in pairs], spec))


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
