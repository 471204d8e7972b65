"""The port's SSD (Mamba-2) scan against the JAX package: the plain torch
version (what the wrapper runs on CPU tensors) against ``ssd_pallas`` in
interpret mode and ``ref.ssd_sequential``, at the shapes of
``tests/test_kernels.py`` plus one 256-step chunk, in f32 and bf16; the
torch oracles against the JAX oracles; the one-token decode step; the
refusals; a decay steep enough that ``exp`` overflows above the
diagonal of a chunk; and the bf16 kernels' roundings, emulated here
(``_emulate_bf16_kernels``), against the plain version and the Pallas
kernel.

Tolerances: y within 5e-4 (1 + |b|) in f32; in bf16 within
2e-2 (rms(b) + |b|) elementwise and 1e-2 norm-relative; h_final within
5e-4 (1 + |b|); b is the JAX value.  Against the sequential oracle (a
different summation order) f32 holds the bound of ``tests/test_kernels.py``
for ``ssd_pallas``: atol 2e-3, rtol 1e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.mamba_scan import ssd_pallas
from repro_torch.kernels import mamba_scan as TM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

SHAPES = [(1, 128, 2, 32, 16, 32), (2, 64, 4, 16, 8, 64),
          (1, 96, 1, 64, 4, 32), (1, 512, 2, 64, 16, 256)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(b, s, nh, dh, N, seed, a_scale=0.5):
    """x, dt = softplus(randn), A = -exp(a_scale randn), B, C, D as
    ``tests/test_kernels.py`` draws them, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, dh), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh), np.float32)))
    A = -np.exp(rng.standard_normal(nh).astype(np.float32) * a_scale)
    B = rng.standard_normal((b, s, N), np.float32)
    C = rng.standard_normal((b, s, N), np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    return x, dt.astype(np.float32), A, B, C, D


def both(arrs, dtype):
    """x, B and C in the working dtype (rounded once, so both packages see
    the same values); dt, A and D in f32."""
    jdt, tdt = DTYPES[dtype]
    x, dt, A, B, C, D = arrs
    j = [jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt),
         jnp.asarray(D)]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(tdt),
         torch.from_numpy(C).to(tdt), torch.from_numpy(D)]
    return j, t


def close(got, want, dtype):
    a = got.double().numpy()
    b = np.asarray(want, np.float64)
    diff = np.abs(a - b)
    if dtype == "float32":
        assert (diff <= 5e-4 * (1 + np.abs(b))).all(), diff.max()
    else:
        rms = np.sqrt((b * b).mean())
        assert (diff <= 2e-2 * (rms + np.abs(b))).all(), diff.max()
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,nh,dh,N,chunk", SHAPES)
def test_plain_matches_pallas_and_sequential(b, s, nh, dh, N, chunk, dtype):
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = both(
        inputs(b, s, nh, dh, N, 3), dtype)
    py, ph = ssd_pallas(jx, jdt, jA, jB, jC, jD, chunk=chunk, interpret=True)
    y, h = TM.ssd_plain(tx, tdt, tA, tB, tC, tD, chunk=chunk)
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    close(y, py.astype(jnp.float32), dtype)
    close(h, ph, "float32")
    # the CPU route of the op entry point is the plain version, exactly
    oy, oh = TO.ssd(tx, tdt, tA, tB, tC, tD, chunk=chunk)
    assert torch.equal(oy, y) and torch.equal(oh, h)
    if dtype == "float32":
        sy, sh = JR.ssd_sequential(jx, jdt, jA, jB, jC, jD)
        np.testing.assert_allclose(y.numpy(), np.asarray(sy), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(h.numpy(), np.asarray(sh), atol=2e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("b,s,nh,dh,N,chunk", SHAPES[:3])
def test_torch_oracles_match_jax_oracles(b, s, nh, dh, N, chunk):
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = both(
        inputs(b, s, nh, dh, N, 5), "float32")
    for jfn, tfn in ((lambda: JR.ssd_sequential(jx, jdt, jA, jB, jC, jD),
                      lambda: TR.ssd_sequential(tx, tdt, tA, tB, tC, tD)),
                     (lambda: JR.ssd_chunked(jx, jdt, jA, jB, jC, jD,
                                             chunk=chunk),
                      lambda: TR.ssd_chunked(tx, tdt, tA, tB, tC, tD,
                                             chunk=chunk))):
        (wy, wh), (gy, gh) = jfn(), tfn()
        close(gy, wy, "float32")
        close(gh, wh, "float32")


def test_strided_b_and_c():
    """B and C as the halves of one projection (row stride 2N), as the
    Mamba block hands them over."""
    x, dt, A, B, C, D = inputs(1, 64, 2, 16, 8, 9)
    bc = torch.from_numpy(np.concatenate([B, C], -1))
    tx, tdt, tA, tD = (torch.from_numpy(a) for a in (x, dt, A, D))
    got = TM.ssd_plain(tx, tdt, tA, bc[..., :8], bc[..., 8:], tD, chunk=32)
    want = TM.ssd_plain(tx, tdt, tA, torch.from_numpy(B),
                        torch.from_numpy(C), tD, chunk=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_step_matches_reference(dtype):
    rng = np.random.default_rng(11)
    b, nh, dh, N = 3, 2, 16, 8
    h = rng.standard_normal((b, nh, dh, N), np.float32)
    x, dt, A, B, C, D = inputs(b, 1, nh, dh, N, 12)
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = both(
        (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D), dtype)
    wy, wh = JR.ssd_decode_step(jnp.asarray(h), jx, jdt, jA, jB, jC, jD)
    gy, gh = TO.ssd_decode(torch.from_numpy(h), tx, tdt, tA, tB, tC, tD)
    assert gy.dtype == tx.dtype and gh.dtype == torch.float32
    close(gy, np.asarray(wy.astype(jnp.float32)), dtype)
    close(gh, wh, "float32")


def test_refusals():
    x, dt, A, B, C, D = (torch.from_numpy(a)
                         for a in inputs(1, 96, 1, 16, 4, 1))
    with pytest.raises(ValueError, match="not a multiple of chunk 64"):
        TM.ssd_scan(x, dt, A, B, C, D, chunk=64)
    with pytest.raises(ValueError, match="decode uses ssd_decode"):
        TM.ssd_scan(x, dt, A, B, C, D, chunk=32,
                    h0=torch.zeros(1, 1, 16, 4))
    # the reference refuses the same chunk
    with pytest.raises(AssertionError):
        ssd_pallas(*(jnp.asarray(t.numpy()) for t in (x, dt, A, B, C, D)),
                   chunk=64, interpret=True)


def test_steep_decay_overflows_nowhere():
    """|A| dt up to ~50 a step: exp(seg_i - seg_j) above the diagonal is
    far past the f32 range.  y stays finite and equal to the reference."""
    x, dt, A, B, C, D = inputs(1, 128, 2, 32, 8, 21, a_scale=0.0)
    A = np.array([-30.0, -0.05], np.float32)
    dt = dt * 10
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = both(
        (x, dt, A, B, C, D), "float32")
    py, ph = ssd_pallas(jx, jdt, jA, jB, jC, jD, chunk=64, interpret=True)
    y, h = TM.ssd_plain(tx, tdt, tA, tB, tC, tD, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y, py, "float32")
    close(h, ph, "float32")


def test_cpu_route_counts_no_launch():
    before = TM.ssd_scan.launches
    TM.ssd_scan(*(torch.from_numpy(a) for a in inputs(1, 32, 1, 8, 4, 2)),
                chunk=32)
    assert TM.ssd_scan.launches == before


def _bf16_split(t):
    """t as the bf16 kernels feed it to a product: hi = bf16(t) plus the
    bf16 rest lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _emulate_bf16_kernels(x, dt, A, B, C, D, chunk, split_wb=True):
    """(y, h_final) as the three bf16 kernels compute them: products of
    bf16 operands summed in f32; w o B (the state kernel) and M (the chunk
    scan's decay-weighted C B^T, masked before the exp) split into bf16
    hi + lo; the pass between chunks in f32; h_in rounded once to bf16 for
    the cross-chunk term; y with the reference's rounding, bf16(bf16(y) +
    bf16(D x)).  ``split_wb=False`` rounds w o B once instead."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    c = min(chunk, s)
    nc = s // c
    xf = x.float().reshape(b, nc, c, nh, dh)
    dtf = dt.float().reshape(b, nc, c, nh)
    Bf, Cf = (t.float().reshape(b, nc, c, N) for t in (B, C))
    seg = torch.cumsum(dtf * A.float(), 2)                 # (b,z,c,nh)
    tot = seg[:, :, -1]                                    # (b,z,nh)
    w = dtf * torch.exp(tot[:, :, None] - seg)
    wb = w[..., None] * Bf[:, :, :, None, :]               # (b,z,j,nh,N)
    wb = _bf16_split(wb) if split_wb else wb.to(torch.bfloat16).float()
    states = torch.einsum("bzjhp,bzjhn->bzhpn", xf, wb)
    h = torch.zeros(b, nh, dh, N)
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * torch.exp(tot[:, z])[..., None, None] + states[:, z]
    h_in = torch.stack(h_in, 1).to(torch.bfloat16).float()  # (b,z,nh,dh,N)
    cb = torch.einsum("bzin,bzjn->bzij", Cf, Bf)
    causal = torch.ones(c, c, dtype=torch.bool).tril()[None, None, :, :, None]
    rel = seg[:, :, :, None] - seg[:, :, None]             # (b,z,i,j,nh)
    decm = torch.exp(torch.where(causal, rel, torch.full_like(rel, -np.inf)))
    m = _bf16_split(cb[..., None] * decm * dtf[:, :, None])
    y = torch.einsum("bzijh,bzjhp->bzihp", m, xf) + torch.einsum(
        "bzin,bzhpn->bzihp", Cf, h_in) * torch.exp(seg)[..., None]
    y = y.reshape(b, s, nh, dh).to(torch.bfloat16)
    skip = (D.float()[None, None, :, None] * x.float()).to(torch.bfloat16)
    return y + skip, h


def _bar_ratio(a, b):
    """Largest |a - b| / (2e-2 (rms(b) + |b|)) and the norm-relative error:
    the card's bf16 bar holds where the first is <= 1, the second <= 1e-2."""
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    rms = b.square().mean().sqrt()
    return ((diff / (2e-2 * (rms + b.abs()))).max().item(),
            (diff.norm() / b.norm()).item())


@pytest.mark.parametrize("b,s,nh,dh,N,chunk,dt_scale", [
    (1, 1024, 2, 128, 16, 256, 1.0),    # several chunks of the prefill's 256
    (1, 100, 2, 80, 12, 256, 1.0),      # one ragged chunk, N and dh ragged
    (1, 768, 2, 64, 16, 256, 4.0),      # steep decay: exp overflows above
])                                      # the diagonal many times over
def test_bf16_kernel_rounding_within_bar(b, s, nh, dh, N, chunk, dt_scale):
    """The bf16 kernels' roundings (``_emulate_bf16_kernels``) against the
    plain version and the JAX ``ssd_pallas`` (interpret), from the same
    bf16 inputs: y within the card's bf16 bar (2e-2 (rms(b) + |b|), 1e-2
    norm-relative), h_final within 5e-4 (1 + |b|)."""
    x, dt, A, B, C, D = inputs(b, s, nh, dh, N, 17)
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = both(
        (x, dt * dt_scale, A, B, C, D), "bfloat16")
    y, h = _emulate_bf16_kernels(tx, tdt, tA, tB, tC, tD, chunk)
    py, ph = TM.ssd_plain(tx, tdt, tA, tB, tC, tD, chunk=chunk)
    jy, jh = ssd_pallas(jx, jdt, jA, jB, jC, jD, chunk=chunk, interpret=True)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for name, want in (("plain", py), ("pallas", torch.tensor(
            np.asarray(jy.astype(jnp.float32))))):
        ratio, rel = _bar_ratio(y, want)
        assert ratio <= 1.0 and rel <= 1e-2, (name, ratio, rel)
    close(h, ph, "float32")
    close(h, jh, "float32")


def test_state_weights_rounded_once_miss_the_bar():
    """Why the state kernel splits w o B into bf16 hi + lo: rounded once,
    h_final leaves its 5e-4 (1 + |b|) bar against the plain version."""
    x, dt, A, B, C, D = inputs(1, 1024, 2, 128, 16, 17)
    _, (tx, tdt, tA, tB, tC, tD) = both((x, dt, A, B, C, D), "bfloat16")
    _, h = _emulate_bf16_kernels(tx, tdt, tA, tB, tC, tD, 256,
                                 split_wb=False)
    _, ph = TM.ssd_plain(tx, tdt, tA, tB, tC, tD, chunk=256)
    diff = (h.double() - ph.double()).abs()
    assert (diff > 5e-4 * (1 + ph.double().abs())).any()
