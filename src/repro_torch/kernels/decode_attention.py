"""Single-token GQA decode attention (flash-decoding) on Hopper.

Port of ``repro/kernels/decode_attention.py::decode_attention_pallas``
(the dense per-slot cache) and ``paged_decode_attention_pallas`` (a
paged pool, ``page_table[b, j]`` naming the page of key block ``j``) as
CUDA C++ in ``csrc/decode_attention.cu``.  bf16 is one launch a call: a
cluster of up to 8 CTAs per (kv head, slot) splits the slot's live keys,
streams K and V through a ``cp.async`` ring into ``mma.sync`` products
under an f32 online softmax, and merges on chip; f32 keeps a CTA per
256-key chunk and a second pass that merges the chunks.  The two layouts
differ only in where a row lies.  The source note there says what bounds
it (bytes: ~2*G flops per cached byte) and how the design answers it.

``decode_attention_plain`` and ``paged_decode_attention_plain`` are the
plain torch versions: the wrappers take them only for CPU tensors; CUDA
tensors launch the kernel or raise; tensors that hold no data take
``kernels/fake.py``'s branch, with the work ``cost`` counts.  All mask
positions ``>= lengths[b]`` (so a ragged ``S_max`` needs no block
multiple) and give 0 for a slot with no live position, as the Pallas
kernels do.  The paged forms never read the table entry of a page that
starts at or past ``lengths[b]`` (such entries may hold -1).  The paged
decode lies on no path of the engine, which decodes from dense slot
caches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, fake, ref

SPLIT = 256          # keys per CTA of the f32 kernel
MAX_CLUSTER = 8      # CTAs per (kv head, slot) of the bf16 kernel, at most
LONG_SHARE = 2048    # keys a bf16 CTA may stream before more CTAs pay off
HEAD_DIMS = (32, 64, 128, 160)
MAX_GROUP = 8        # query heads per kv head (the rows of an mma tile)
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
    if not q.is_cuda and fake.holds_data(q):
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    return _launch(q, k_cache, v_cache, lengths, scale)


decode_attention.launches = 0


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 *, scale: Optional[float] = None):
    """q (B,H,dk), pools (n_pages,page,Hkv,d), page_table (B,npp) int,
    lengths (B,) -> (B,H,dv): each slot's live pages gathered into a
    dense row, then ``decode_attention_plain``."""
    kc, vc = ref.gather_pages(k_pages, v_pages, page_table, lengths)
    return decode_attention_plain(q, kc, vc, lengths, scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           scale: Optional[float] = None):
    """Paged-pool single-token decode: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if not q.is_cuda and fake.holds_data(q):
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, scale=scale)
    return _launch_paged(q, k_pages, v_pages, page_table, lengths, scale)


paged_decode_attention.launches = 0


def cost(q, k, v, lengths=None, page_table=None, page: int = 0) -> dict:
    """The work of one call, ``{ops, bytes, dtype}``
    (``timing.cost_bound_ms`` turns it into a bound): each live K and V
    row read once, q read and out written, the int32 lengths, and (paged,
    ``page_table`` given, ``page`` tokens a page) each live page's table
    entry; 2 (dk + dv) flops a live key and query head.  The live keys
    are ``lengths`` (a sequence of ints) where the caller has them, as
    the benches do, and the whole cache where it has not, as a dry run's
    "one new token against a seq_len cache"."""
    B, H, dk = q.shape
    hkv, dv = v.shape[2], v.shape[3]
    if lengths is None:
        cap = (page_table.shape[1] * page if page_table is not None
               else v.shape[1])
        lengths = [cap] * B
    live = sum(lengths)
    e = q.element_size()
    n_bytes = e * (live * hkv * (dk + dv) + B * H * (dk + dv)) + 4 * B
    if page_table is not None:
        n_bytes += 4 * sum(-(-n // page) for n in lengths)
    return {"ops": 2 * live * H * (dk + dv), "bytes": n_bytes,
            "dtype": q.dtype}


def _check_common(q, k, v, lengths, H, hkv, real: bool = True):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode attention takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if H % hkv or H // hkv > MAX_GROUP:
        raise ValueError(f"{H} query heads over {hkv} kv heads: the kernel "
                         f"takes up to {MAX_GROUP} a group")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != q.shape[:1]:
        raise ValueError("lengths must be int32 (B,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device or not t.is_contiguous() \
                or (real and t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")


def _launch_paged(q, k_pages, v_pages, page_table, lengths, scale):
    B, H, dk = q.shape
    _, page, hkv, dv = v_pages.shape
    npp = page_table.shape[1]
    if dk not in HEAD_DIMS or dv not in HEAD_DIMS or (dk == 160) != (
            dv == 160):
        raise ValueError(f"head dims {dk}/{dv}: the kernel takes q/k and v "
                         f"widths in {HEAD_DIMS} (160 only with 160)")
    if tuple(k_pages.shape) != (v_pages.shape[0], page, hkv, dk) \
            or tuple(page_table.shape) != (B, npp):
        raise ValueError(f"shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pages.shape)} v {tuple(v_pages.shape)} "
                         f"page_table {tuple(page_table.shape)}")
    real = fake.holds_data(q)
    _check_common(q, k_pages, v_pages, lengths, H, hkv, real)
    if page_table.dtype != torch.int32 or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError(f"page_table must be a contiguous int32 tensor on "
                         f"{q.device}")
    out = _run(q, k_pages, v_pages, page_table, lengths, npp * page, page,
               dv, scale, "paged_decode_attention")
    if real:
        paged_decode_attention.launches += 1
    return out


def _launch(q, k_cache, v_cache, lengths, scale):
    B, H, dk = q.shape
    _, S_max, hkv, dv = v_cache.shape
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"head dims {dk}/{dv}: the kernel takes equal q/k "
                         f"and v widths in {HEAD_DIMS}")
    if tuple(k_cache.shape) != (B, S_max, hkv, dk):
        raise ValueError(f"shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    real = fake.holds_data(q)
    _check_common(q, k_cache, v_cache, lengths, H, hkv, real)
    out = _run(q, k_cache, v_cache, None, lengths, S_max, 0, dv, scale,
               "decode_attention")
    if real:
        decode_attention.launches += 1
    return out


def _run(q, k, v, page_table, lengths, cap, page, dv, scale, what,
         splits=None):
    """One call of the C entry point over ``cap`` cached positions a slot
    (``page_table`` None: the dense cache).  bf16 is one cluster launch
    of ``splits`` CTAs per (kv head, slot), ``_splits``'s choice unless
    given, and needs no scratch; f32 gets its chunks' partials.  Tensors
    that hold no data get the same allocations, and ``cost`` over the
    whole cache is recorded in place of the launch."""
    B, H, dk = q.shape
    hkv = k.shape[2]
    out = torch.empty(B, H, dv, dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if q.dtype == torch.float32:
        splits = splits or max(1, -(-cap // SPLIT))
        n = B * hkv * splits * (H // hkv)
        part_acc = torch.empty(n * dv, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(n * 2, dtype=torch.float32, device=q.device)
    if not fake.holds_data(q):
        fake.record(what, cost(q, k, v, page_table=page_table, page=page))
        return out
    if splits is None:
        splits = _splits(q.device, B * hkv, cap)
    err = _lib().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), B, H, hkv, cap,
        page, dk, dv, _DTYPES[q.dtype], splits, float(scale or dk ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(device, pairs: int, cap: int) -> int:
    """CTAs of the bf16 kernel's cluster per (kv head, slot), a power of
    two up to 8 and no more than the cache has 64-key tiles.  It doubles
    while all ``pairs`` clusters still fit one wave at one CTA an SM; past
    that only while a CTA would stream more than ``LONG_SHARE`` keys of
    ``cap``.  The host does not see the lengths, so the first rule serves
    the engine's calls (8 slots x 8 kv heads, S_max 2048, a few hundred
    live keys a slot: 2 CTAs), where a call's fixed cost, which grows with
    the cluster, outweighs its reads; the second serves S_max above 4096
    at 8 x 8 (8 CTAs at 32768), which none of the engine's calls have
    today.  ``kernels/decode_bench.py --sweep`` times every size at a
    shape on each side."""
    sms = _sm_count(device.index)
    n = 1
    while n < MAX_CLUSTER and 64 * n < cap and (
            2 * n * pairs <= sms or cap > LONG_SHARE * n):
        n *= 2
    return n


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 9 + [ctypes.c_float, P]
        fn.restype = I
    return lib
