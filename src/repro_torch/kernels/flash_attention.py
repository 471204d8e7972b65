"""FlashAttention forward and backward on Hopper.

Port of ``repro/kernels/flash_attention.py::flash_attention_pallas`` (the
forward) together with the two-pass backward the JAX package pairs with
it (``repro/kernels/ref.py::_flash_bwd``), as CUDA C++ in
``csrc/flash_attention.cu``: the forward streams K/V tiles under an f32
online softmax and saves the log-sum-exp; the backward recomputes p from
it, with a pass for dq and a pass for dk/dv that sums the query heads of
each kv head inside one CTA.  bf16 runs on the tensor cores (the forward
on wgmma fed by TMA, the backward on mma.sync fed by cp.async); f32 runs
on scalar kernels that hold 2e-5.  The source note there says what
bounds the kernels and what the design does about it.

``flash_fwd`` and ``flash_bwd`` launch the kernels on CUDA tensors (or
raise) and run the plain versions of ``kernels/ref.py`` on CPU tensors.
``FlashAttention`` joins them as a ``torch.autograd.Function``;
``flash_attention`` is its entry point.  The forward takes head dims
``FWD_HEAD_DIMS`` on the card, the backward ``BWD_HEAD_DIMS``: d 160
(pixtral-12b) has a forward only, so on CUDA ``flash_attention``
refuses it before any work where a gradient will be asked for (ROADMAP
Queue 2 A1).  Masking follows the Pallas kernel: a causal query attends
keys at or before its own position (``qpos >= kpos``), and any S works.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

FWD_HEAD_DIMS = (32, 64, 80, 128, 160)
BWD_HEAD_DIMS = (32, 64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None):
    """q (B,S,H,d), k/v (B,Sk,Hkv,d) -> (out (B,S,H,d), lse (B,H,S) f32):
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if not q.is_cuda:
        return ref.flash_fwd(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, FWD_HEAD_DIMS)
    B, S, H, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, k.shape[1], H, k.shape[2], d,
        _DTYPES[q.dtype], int(causal), float(scale or d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              scale: Optional[float] = None):
    """Gradients (dq, dk, dv) in the input dtypes from the forward's
    ``out`` and ``lse`` and the output gradient ``dout``: the CUDA
    kernels (Delta pre-pass, dq pass, dk/dv pass) on CUDA tensors, the
    plain version on CPU tensors."""
    if not q.is_cuda:
        return ref.flash_bwd(q, k, v, out, lse, dout, causal=causal,
                             scale=scale)
    _check(q, k, v, BWD_HEAD_DIMS)
    B, S, H, d = q.shape
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        shape = (B, H, S) if name == "lse" else tuple(q.shape)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} tensor of shape {shape} on "
                             f"{q.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = _lib().flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, k.shape[1], H, k.shape[2], d,
        _DTYPES[q.dtype], int(causal), float(scale or d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the hand-written backward: saves (q, k, v,
    out, lse), as the reference's custom VJP does, never the S x S
    probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q (B,S,H,d), k/v (B,Sk,Hkv,d) -> (B,S,H,d), differentiable.  On
    CUDA tensors a head dim with no backward kernel is refused here,
    before any launch, when a gradient will be asked for (grad mode on
    and an input that requires it; inside the Function's forward grad
    mode is always off)."""
    if q.is_cuda and q.dim() == 4 and q.shape[-1] not in BWD_HEAD_DIMS \
            and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            f"head dim {q.shape[-1]}: the flash backward takes "
            f"{BWD_HEAD_DIMS} on the card, and a gradient will be asked for "
            "(the forward alone runs under torch.no_grad or inference_mode; "
            "ROADMAP Queue 2 A1)")
    return FlashAttention.apply(q, k, v, causal, scale)


def _check(q, k, v, head_dims):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want (B,S,H,d) and "
                         f"(B,Sk,Hkv,d)")
    B, S, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[2] or S == 0 \
            or k.shape[1] == 0:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in head_dims:
        raise ValueError(f"head dim {d}: the kernel takes {head_dims}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [P] * 5 + [I] * 8 + [F, P]
        lib.flash_fwd.restype = I
        lib.flash_bwd.argtypes = [P] * 10 + [I] * 8 + [F, P]
        lib.flash_bwd.restype = I
    return lib
