"""Single-token GQA decode attention (flash-decoding) on Hopper.

Port of ``repro/kernels/decode_attention.py::decode_attention_pallas``
(the dense per-slot cache; the paged variant waits for a later slice) as
CUDA C++ in ``csrc/decode_attention.cu``: one CTA per (S-split, kv head,
slot) streams its K/V rows once with 16-byte loads under an f32 online
softmax, and a second pass merges the splits.  The source note there
says what bounds it (bytes: ~2*G flops per cached byte) and how the
design answers it.

``decode_attention_plain`` is the plain torch version: the wrapper takes
it only for CPU tensors; CUDA tensors launch the kernel or raise.  Both
mask positions ``>= lengths[b]`` (so a ragged ``S_max`` needs no block
multiple) and give 0 for a slot with no live position, as the Pallas
kernel does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

SPLIT = 256          # keys per CTA; a multiple of the kernel's 64-key tile
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8        # query heads per kv head the kernel holds in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q, k_cache, v_cache, lengths, *,
                           scale: Optional[float] = None):
    """q (B,H,dk), caches (B,S_max,Hkv,d), lengths (B,) -> (B,H,dv):
    a masked softmax over the whole row in f32."""
    B, H, dk = q.shape
    hkv = k_cache.shape[2]
    scale = scale or dk ** -0.5
    qg = q.reshape(B, hkv, H // hkv, dk).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    live = (pos[None] < lengths[:, None])[:, None, None]
    s = torch.where(live, s, torch.full_like(s, -math.inf))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    o = torch.einsum("bkgs,bske->bkge", p, v_cache.float())
    o = o / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return o.reshape(B, H, -1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     scale: Optional[float] = None):
    """Dense-cache single-token decode: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    return _launch(q, k_cache, v_cache, lengths, scale)


decode_attention.launches = 0


def _launch(q, k_cache, v_cache, lengths, scale):
    B, H, dk = q.shape
    _, S_max, hkv, dv = v_cache.shape
    dev = q.device
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}")
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"head dims {dk}/{dv}: the kernel takes equal q/k "
                         f"and v widths in {HEAD_DIMS}")
    if tuple(k_cache.shape) != (B, S_max, hkv, dk) or H % hkv \
            or H // hkv > MAX_GROUP:
        raise ValueError(f"shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError("lengths must be int32 (B,)")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {dev}")
    g = H // hkv
    n_split = max(1, -(-S_max // SPLIT))
    out = torch.empty_like(q)
    part_acc = torch.empty(B * hkv * n_split * g * dk, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(B * hkv * n_split * g * 2, dtype=torch.float32,
                          device=dev)
    err = _lib().decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), B, H, hkv, S_max, dk, _DTYPES[q.dtype], SPLIT,
        n_split, float(scale or dk ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 8 + [ctypes.c_float, P]
        fn.restype = I
    return lib
