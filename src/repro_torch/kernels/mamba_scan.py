"""Chunked SSD (Mamba-2) scan forward on Hopper.

Port of ``repro/kernels/mamba_scan.py::ssd_pallas`` as CUDA C++ in
``csrc/mamba_scan.cu``: in bf16 three kernel launches a call (chunk
states, the pass of the state between chunks, the chunk outputs), the
chunk products on the tensor cores; in f32 one scalar kernel.  For each
chunk of ``c = min(chunk, s)`` steps, with ``seg`` the inclusive cumsum
of ``ldec = dt * A`` (formed in f32 before the cumsum, as the Pallas
kernel does):

    y_cross = exp(seg) * (C h_prev^T)
    y_intra = ((C B^T) o causal exp(seg_i - seg_j) o dt_j) x
    h      <- exp(tot) h_prev + sum_j dt_j exp(tot - seg_j) x_j B_j^T

and ``y = (y_intra + y_cross)`` cast to x's dtype, plus the D skip cast
to that dtype, as ``ssd_pallas`` adds it.  The source note in the CUDA
file says what bounds the kernel and how its design answers it.

``ssd_plain`` is the plain torch version (the Pallas kernel's math, one
chunk at a time): the wrapper takes it only for CPU tensors; CUDA
tensors launch the kernel or raise; tensors that hold no data take
``kernels/fake.py``'s branch, with the work ``cost`` counts.  Both
return the f32 state after the last chunk, the state they carried; the
reference recomputes it outside its kernel (``_final_state``), and the
tests hold the two together.
Neither has a gradient, like the reference's kernel: training a Mamba
model on the card waits for an SSD backward (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, fake

MAX_CHUNK = 256      # rows of a chunk the kernel stages in shared memory
MAX_STATE = 16       # state width N the kernel holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _chunk(s: int, chunk: int) -> int:
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"SSD scan: sequence {s} is not a multiple of "
                         f"chunk {c}")
    return c


def ssd_plain(x, dt, A, B, C, D, *, chunk: int = 256):
    """x (b,s,nh,dh), dt (b,s,nh), A (nh,), B/C (b,s,N), D (nh,) ->
    (y (b,s,nh,dh) in x's dtype, h_final (b,nh,dh,N) f32), chunk by
    chunk as ``ssd_pallas`` computes it."""
    b, s, nh, dh = x.shape
    c = _chunk(s, chunk)
    ldec = dt.float() * A.float()[None, None, :]
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(b, nh, dh, B.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for z in range(s // c):
        sl = slice(z * c, (z + 1) * c)
        xb = x[:, sl].float()                          # (b,c,nh,dh)
        dtz, Bz, Cz = dt[:, sl].float(), B[:, sl].float(), C[:, sl].float()
        seg = torch.cumsum(ldec[:, sl], 1)             # (b,c,nh)
        tot = seg[:, -1]                               # (b,nh)
        y_cross = torch.einsum("bin,bhdn->bihd", Cz, h) \
            * torch.exp(seg)[..., None]
        # masked to -inf before exp: the upper triangle overflows
        rel = seg[:, :, None, :] - seg[:, None, :, :]  # (b,i,j,nh)
        decm = torch.exp(torch.where(causal[None, :, :, None], rel,
                                     torch.full_like(rel, -math.inf)))
        cb = torch.einsum("bin,bjn->bij", Cz, Bz)
        m = cb[..., None] * decm * dtz[:, None]
        y_intra = torch.einsum("bijh,bjhd->bihd", m, xb)
        ys.append((y_intra + y_cross).to(x.dtype))
        w = (dtz * torch.exp(tot[:, None] - seg))[..., None] * xb
        states = torch.einsum("bchd,bcn->bhdn", w, Bz)
        h = h * torch.exp(tot)[..., None, None] + states
    y = torch.cat(ys, 1)
    skip = (D.float()[None, None, :, None] * x.float()).to(x.dtype)
    return y + skip, h


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, h0=None):
    """The SSD chunked scan forward: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors.  Refuses ``h0`` like the reference
    (decode carries states through ``ssd_decode_step``)."""
    if h0 is not None:
        raise ValueError("ssd_scan is the full-sequence path; decode uses "
                         "ssd_decode")
    if not x.is_cuda and fake.holds_data(x):
        return ssd_plain(x, dt, A, B, C, D, chunk=chunk)
    return _launch(x, dt, A, B, C, D, chunk)


ssd_scan.launches = 0


def cost(x, dt, A, B, C, D, *, chunk: int = 256) -> dict:
    """The work of one call, ``{ops, bytes, dtype}``
    (``timing.cost_bound_ms`` turns it into a bound): bytes, x and y in
    x's dtype, dt and dt * A in f32, B and C in x's dtype, the f32 D and
    the f32 h_final; operations, the products the Pallas kernel does a
    (chunk, head), dense over the chunk: C B^T, M x, C h^T and the
    state."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    c = _chunk(s, chunk)
    e = x.element_size()
    n_bytes = (2 * e * b * s * nh * dh + 2 * 4 * b * s * nh
               + 2 * e * b * s * N + 4 * nh + 4 * b * nh * dh * N)
    n_ops = (s // c) * b * nh * (2 * c * c * N + 2 * c * c * dh
                                 + 2 * 2 * c * N * dh)
    return {"ops": n_ops, "bytes": n_bytes, "dtype": x.dtype}


def _launch(x, dt, A, B, C, D, chunk):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        raise NotImplementedError(
            "ssd_scan has no gradient, like the reference's Pallas kernel "
            "(ssd_pallas): training a Mamba model on the card waits for "
            "an SSD backward (ROADMAP Queue 1 item 7)")
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    c = _chunk(s, chunk)
    dev = x.device
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan takes f32 or bf16 x/B/C of one dtype, "
                         f"got {x.dtype}/{B.dtype}/{C.dtype}")
    if c > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan holds chunks up to {MAX_CHUNK} rows and "
                         f"states up to N={MAX_STATE}; got chunk {c}, N {N}"
                         f" (dh is split across blocks and has no limit)")
    if tuple(dt.shape) != (b, s, nh) or tuple(A.shape) != (nh,) \
            or tuple(D.shape) != (nh,) or tuple(B.shape) != (b, s, N) \
            or tuple(C.shape) != (b, s, N):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} D {tuple(D.shape)}")
    # B and C may be strided views (the halves of one projection): their
    # batch and row strides go to the kernel, the state axis must be dense
    real = fake.holds_data(x)
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.device != dev or t.stride(-1) != 1 \
                or (name == "x" and not t.is_contiguous()):
            raise ValueError(f"{name} must lie on {dev} with a dense last "
                             f"axis (x contiguous)")
    dtf = dt.float().contiguous()
    ldec = (dtf * A.float()[None, None, :]).contiguous()
    Df = D.float().contiguous()
    y = torch.empty_like(x)
    h = torch.empty(b, nh, dh, N, dtype=torch.float32, device=dev)
    # bf16 scratch: each chunk's state, then (in place) the state entering
    # it, and each chunk's decay exp(tot)
    nc = s // c if x.dtype == torch.bfloat16 else 0
    states = torch.empty(b, nc, nh, dh, N, dtype=torch.float32, device=dev)
    decay = torch.empty(b, nc, nh, dtype=torch.float32, device=dev)
    if not real:
        fake.record("ssd_scan", cost(x, dt, A, B, C, D, chunk=chunk))
        return y, h
    err = _lib().ssd_scan(
        x.data_ptr(), dtf.data_ptr(), ldec.data_ptr(), B.data_ptr(),
        C.data_ptr(), Df.data_ptr(), y.data_ptr(), h.data_ptr(),
        states.data_ptr(), decay.data_ptr(), b, s, nh, dh, N, c,
        B.stride(0), B.stride(1), C.stride(0), C.stride(1), _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


def _lib():
    lib = _build.load("mamba_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 10 + [I] * 6 + [L] * 4 + [I, P]
        fn.restype = I
    return lib
