"""One-token absorbed MLA decode over a latent cache on Hopper.

Replaces no kernel of the JAX package: its absorbed decode
(``repro/models/attention.py::mla_decode``) is lax.  ``csrc/mla_decode.cu``
takes the bf16 serving path at DeepSeek-V2's latent widths (L 512, rope
64): a CTA per 32 query heads of a slot streams the slot's live latent
rows through a ``cp.async`` ring into ``mma.sync`` products under an f32
online softmax, one launch a call.  The source note says what bounds it
(the tensor cores, then L2: ~240 flops a cached byte at 128 heads) and
how the design answers it.

``mla_decode_plain`` is the plain torch version, the port's earlier
decode: blocks of ``min(2048, S_max)`` rows under an f32 online softmax,
products of the cache's dtype accumulated in f32, P rounded once to the
cache's dtype.  The wrapper takes it for CPU tensors; CUDA tensors
launch the kernel or raise; tensors that hold no data take
``kernels/fake.py``'s branch, with the work ``cost`` counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, fake

LATENT = 512       # the kernel's latent width (kv_lora_rank)
ROPE = 64          # and rope width
HEAD_BLOCK = 32    # query heads a CTA


def mla_decode_plain(q_lat, q_rope, ckv, krope, lengths):
    """q_lat (B,H,L) and q_rope (B,H,R), scaled, in the cache's dtype;
    ckv (B,S_max,L), krope (B,S_max,R); lengths (B,) the live rows of
    each slot -> (B,H,L) in q's dtype.  The ``S_max // bs`` whole blocks
    are attended: a tail past the last one is not (the engine's S_max is
    a multiple of bs)."""
    B, H, L = q_lat.shape
    qf, qr = q_lat.float(), q_rope.float()
    s_max = ckv.shape[1]
    bs = min(2048, s_max)
    live = lengths.long()
    dev = ckv.device
    acc = torch.zeros(B, H, L, dtype=torch.float32, device=dev)
    mx = torch.full((B, H), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, dtype=torch.float32, device=dev)
    for i in range(s_max // bs):
        cb = ckv[:, i * bs:(i + 1) * bs].float()
        rb = krope[:, i * bs:(i + 1) * bs].float()
        s = (torch.einsum("bhl,bsl->bhs", qf, cb)
             + torch.einsum("bhr,bsr->bhs", qr, rb))
        pos = i * bs + torch.arange(bs, device=dev)
        s = torch.where((pos[None] < live[:, None])[:, None], s,
                        torch.full_like(s, -1e30))
        m_new = torch.maximum(mx, s.amax(-1))
        alpha = torch.exp(mx - m_new)
        pr = torch.exp(s - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhs,bsl->bhl", pr.to(ckv.dtype).float(), cb)
        mx = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q_lat.dtype)


def mla_decode(q_lat, q_rope, ckv, krope, lengths):
    """The absorbed latent decode: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not q_lat.is_cuda and fake.holds_data(q_lat):
        return mla_decode_plain(q_lat, q_rope, ckv, krope, lengths)
    return _launch(q_lat, q_rope, ckv, krope, lengths)


mla_decode.launches = 0


def cost(B: int, H: int, L: int, R: int, lengths, elem: int = 2,
         dtype=torch.bfloat16) -> dict:
    """The work of one call, ``{ops, bytes, dtype}``: each live latent
    row (L + R numbers) read once for every head, q read and out
    written, the int32 lengths and order; 2 (L + R) flops a live row and
    head for the scores and 2 L for the output.  ``lengths`` are the
    live rows of each of the B slots."""
    live = sum(lengths)
    n_bytes = elem * (live * (L + R) + B * H * (2 * L + R)) + 8 * B
    return {"ops": 2 * live * H * (2 * L + R), "bytes": n_bytes,
            "dtype": dtype}


def _launch(q_lat, q_rope, ckv, krope, lengths):
    B, H, L = q_lat.shape
    R = q_rope.shape[-1]
    if (L, R) != (LATENT, ROPE) or H % HEAD_BLOCK:
        raise ValueError(f"latent {L}, rope {R}, {H} heads: the kernel "
                         f"takes latent {LATENT}, rope {ROPE} and a "
                         f"multiple of {HEAD_BLOCK} heads")
    if tuple(q_rope.shape) != (B, H, R) or ckv.shape[0] != B \
            or tuple(krope.shape) != (B, ckv.shape[1], R) \
            or ckv.shape[2] != L:
        raise ValueError(f"shapes q_lat {tuple(q_lat.shape)} q_rope "
                         f"{tuple(q_rope.shape)} ckv {tuple(ckv.shape)} "
                         f"krope {tuple(krope.shape)}")
    real = fake.holds_data(q_lat)
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
                    ("krope", krope)):
        if t.dtype != torch.bfloat16 or t.device != q_lat.device:
            raise ValueError(f"{name} must be bf16 on {q_lat.device}, got "
                             f"{t.dtype} on {t.device}")
        # rows contiguous; a slot's rows one after another
        if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1] \
                or (real and t.data_ptr() % 16):
            raise ValueError(f"{name} must have contiguous, 16-byte "
                             f"aligned rows")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or lengths.device != q_lat.device:
        raise ValueError("lengths must be int32 (B,) on the same device")
    out = torch.empty(B, H, L, dtype=q_lat.dtype, device=q_lat.device)
    if not real:
        fake.record("mla_decode",
                    cost(B, H, L, R, [ckv.shape[1]] * B))
        return out
    # the longest slots first
    order = torch.argsort(lengths, descending=True).to(torch.int32)
    err = _lib().mla_decode(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), ckv.stride(0), krope.stride(0),
        lengths.data_ptr(), order.data_ptr(), out.data_ptr(), B, H, L, R,
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    _build.check(err, "mla_decode")
    mla_decode.launches += 1
    return out


def _lib():
    lib = _build.load("mla_decode")
    fn = lib.mla_decode
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 4 + [LL] * 2 + [P] * 3 + [I] * 4 + [P]
        fn.restype = I
    return lib
