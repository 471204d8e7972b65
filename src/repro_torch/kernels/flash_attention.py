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
raise) and run the plain versions of ``kernels/ref.py`` on CPU tensors;
tensors that hold no data take ``kernels/fake.py``'s branch, with the
work ``cost`` counts.
``FlashAttention`` joins them as a ``torch.autograd.Function``;
``flash_attention`` is its entry point.  q and k are ``dk`` wide, v and
the output ``dv``: on the card both passes take the pairs ``HEAD_DIMS``,
(d, d) at every family's head dim and MLA's (192, 128), and refuse any
other before a launch.  Masking follows the Pallas kernel: a causal query
attends keys at or before its own position (``qpos >= kpos``), and any S
works.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, fake, ref

# the (dk, dv) pairs the kernels take, forward and backward
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (160, 160),
             (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None):
    """q (B,S,H,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv) -> (out (B,S,H,dv),
    lse (B,H,S) f32): the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors.  ``scale`` defaults to dk ** -0.5."""
    real = fake.holds_data(q)
    if real and not q.is_cuda:
        return ref.flash_fwd(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, real)
    B, S, H, dk = q.shape
    dv = v.shape[3]
    out = torch.empty(B, S, H, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if not real:
        fake.record("flash_fwd", cost(q, k, v, causal=causal))
        return out, lse
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, k.shape[1], H, k.shape[2], dk, dv,
        _DTYPES[q.dtype], int(causal), float(scale or dk ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              scale: Optional[float] = None):
    """Gradients (dq, dk, dv) in the input dtypes from the forward's
    ``out`` and ``lse`` and the output gradient ``dout`` (B,S,H,dv): the
    CUDA kernels (Delta pre-pass, dq pass, dk/dv pass) on CUDA tensors,
    the plain version on CPU tensors."""
    real = fake.holds_data(q)
    if real and not q.is_cuda:
        return ref.flash_bwd(q, k, v, out, lse, dout, causal=causal,
                             scale=scale)
    _check(q, k, v, real)
    B, S, H, dk = q.shape
    dv = v.shape[3]
    for name, t, dtype in (("out", out, q.dtype), ("dout", dout, q.dtype),
                           ("lse", lse, torch.float32)):
        shape = (B, H, S) if name == "lse" else (B, S, H, dv)
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != q.device or not t.is_contiguous() \
                or (real and t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dtype} tensor of shape {shape} on "
                             f"{q.device}")
    dq = torch.empty_like(q)
    dk_ = torch.empty_like(k)
    dv_ = torch.empty_like(v)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if not real:
        fake.record("flash_bwd", cost(q, k, v, causal=causal, backward=True))
        return dq, dk_, dv_
    err = _lib().flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk_.data_ptr(), dv_.data_ptr(), B, S, k.shape[1], H, k.shape[2], dk,
        dv, _DTYPES[q.dtype], int(causal), float(scale or dk ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk_, dv_


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
    """q (B,S,H,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv) -> (B,S,H,dv),
    differentiable."""
    return FlashAttention.apply(q, k, v, causal, scale)


def cost(q, k, v, *, causal: bool = True, backward: bool = False) -> dict:
    """The work of one call at these inputs' shapes, ``{ops, bytes,
    dtype}`` (``timing.cost_bound_ms`` turns it into a bound): causal
    attends half the S x Sk pairs; the forward's products are 2 (dk + dv)
    flops a pair and query head, the backward's necessary five (s, dp,
    dq, dk, dv) 2 (3 dk + 2 dv); each input is read once and each output
    written once: the forward reads q, k, v and writes out and the f32
    lse, the backward reads q, k, v, out, dout and lse and writes dq, dk,
    dv."""
    B, S, H, dk = q.shape
    Sk, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    e = q.element_size()
    pairs = B * H * S * Sk / (2 if causal else 1)
    qkv = e * (B * S * H * dk + B * Sk * hkv * (dk + dv))
    out = e * B * S * H * dv
    lse = 4 * B * H * S
    if backward:
        return {"ops": 2 * pairs * (3 * dk + 2 * dv),
                "bytes": 2 * qkv + 2 * out + lse, "dtype": q.dtype}
    return {"ops": 2 * pairs * (dk + dv), "bytes": qkv + out + lse,
            "dtype": q.dtype}


def _check(q, k, v, real: bool = True):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or tuple(k.shape[:3]) != tuple(v.shape[:3]):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want (B,S,H,dk), "
                         f"(B,Sk,Hkv,dk) and (B,Sk,Hkv,dv)")
    B, S, H, dk = q.shape
    if k.shape[0] != B or k.shape[3] != dk or H % k.shape[2] or S == 0 \
            or k.shape[1] == 0:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if (dk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (dk {dk}, dv {v.shape[3]}): the "
                         f"kernels take (dk, dv) in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() \
                or (real and t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [P] * 5 + [I] * 9 + [F, P]
        lib.flash_fwd.restype = I
        lib.flash_bwd.argtypes = [P] * 10 + [I] * 9 + [F, P]
        lib.flash_bwd.restype = I
    return lib
