"""The port's flash attention (plain versions, which the CUDA kernels are
held against on the card) against the JAX package on the CPU.

* forward: against ``flash_attention_pallas(..., interpret=True)`` and
  ``ref.attention_naive`` on the shapes of ``tests/test_kernels.py``,
  2e-5 in f32 and 2e-2 in bf16 (the tolerances there);
* backward: the port's two-pass backward against ``jax.grad`` of the
  reference's ``flash_attention_blockwise`` (custom VJP), causal and
  not, atol 1e-4 / rtol 1e-3 as in ``test_kernels.py``;
* the ``FlashAttention`` autograd Function under ``gradcheck`` in f64,
  and recomputed correctly under both remat policies;
* the bf16 kernels' arithmetic, emulated here on the CPU (bf16 q/k/v, the
  scale on f32 scores, P and dS split into bf16 hi + lo for the products
  that read them), against the plain versions under the card's bf16 bar:
  every element within 2e-2 (rms(b) + |b|), 1e-2 norm-relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TR
from repro_torch.models import model as TM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def as_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def as_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hkv,dk,causal", [
    (1, 128, 4, 4, 32, True),       # MHA
    (2, 256, 8, 2, 64, True),       # GQA 4:1
    (1, 128, 6, 2, 80, False),      # non-causal, odd head_dim
    (2, 192, 4, 1, 64, True),       # MQA, non-pow2 seq
])
def test_forward_matches_pallas_and_naive(B, S, H, hkv, dk, causal, dtype):
    q, k, v = draws(S + H, (B, S, H, dk), (B, S, hkv, dk), (B, S, hkv, dk))
    jq, jk, jv = (as_jax(x, dtype) for x in (q, k, v))
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True),
        np.float32)
    naive = np.asarray(JR.attention_naive(jq, jk, jv, causal=causal),
                       np.float32)
    tq, tk, tv = (as_torch(x, dtype) for x in (q, k, v))
    out, lse = FA.flash_fwd(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and lse.shape == (B, H, S)
    got = out.float().numpy()
    np.testing.assert_allclose(got, pallas, atol=TOL[dtype])
    np.testing.assert_allclose(got, naive, atol=TOL[dtype])
    np.testing.assert_allclose(
        TR.attention_naive(tq, tk, tv, causal=causal).float().numpy(), naive,
        atol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_custom_vjp(causal):
    B, S, H, hkv, dk = 2, 128, 4, 2, 32
    q, k, v, ct = draws(27, (B, S, H, dk), (B, S, hkv, dk), (B, S, hkv, dk),
                        (B, S, H, dk))
    want = jax.grad(lambda *a: (JR.flash_attention_blockwise(
        *a, causal=causal, block_q=32, block_k=64) * ct).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FA.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)
    # the reference's residuals: its forward's lse is the port's, reshaped
    _, jlse = JR._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                            causal=causal, scale=None, block_q=32,
                            block_k=64)
    _, tlse = TR.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                           causal=causal, block_q=32, block_k=64)
    np.testing.assert_allclose(tlse.numpy(),
                               np.asarray(jlse).reshape(B, H, S), atol=1e-5)


def test_ragged_blocks_and_cross_lengths():
    """Blocks that do not divide S, and Sq != Sk: the plain versions
    against the naive oracle (non-causal, and causal at Sq == Sk where the
    two causal masks agree)."""
    q, k, v, ct = draws(3, (1, 100, 4, 16), (1, 70, 2, 16), (1, 70, 2, 16),
                        (1, 100, 4, 16))
    tq, tk, tv = (torch.from_numpy(x).double() for x in (q, k, v))
    out, _ = TR.flash_fwd(tq, tk, tv, causal=False, block_q=32, block_k=24)
    torch.testing.assert_close(out, TR.attention_naive(tq, tk, tv,
                                                       causal=False))
    tk2, tv2 = (torch.from_numpy(x).double() for x in draws(4, (1, 100, 2, 16),
                                                            (1, 100, 2, 16)))
    out, lse = TR.flash_fwd(tq, tk2, tv2, causal=True, block_q=32,
                            block_k=24)
    torch.testing.assert_close(out, TR.attention_naive(tq, tk2, tv2))
    leaves = [t.clone().requires_grad_() for t in (tq, tk2, tv2)]
    want = torch.autograd.grad((TR.attention_naive(*leaves)
                                * torch.from_numpy(ct).double()).sum(),
                               leaves)
    got = TR.flash_bwd(tq, tk2, tv2, out, lse, torch.from_numpy(ct).double(),
                       block_q=32, block_k=24)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradcheck_f64(causal):
    g = torch.Generator().manual_seed(11)
    q = torch.randn(1, 9, 4, 8, dtype=torch.float64, generator=g)
    k = torch.randn(1, 9, 2, 8, dtype=torch.float64, generator=g)
    v = torch.randn(1, 9, 2, 8, dtype=torch.float64, generator=g)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda *a: FA.flash_attention(*a, causal=causal), leaves)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_function_recomputed_under_checkpoint(remat):
    """Under ``use_reentrant=False`` checkpointing (whole and selective)
    the Function's forward runs again in the backward, and the gradients
    equal those without remat."""
    q, k, v, w = draws(8, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32),
                       (2, 64, 4, 32))
    wt = torch.from_numpy(w)
    calls = []

    def body(q, k, v):
        calls.append(1)
        return FA.flash_attention(q @ torch.eye(32), k, v) * wt

    grads, runs = {}, {}
    for mode in ("none", remat):
        calls.clear()
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fn = TM._remat(body, mode)
        grads[mode] = torch.autograd.grad(fn(*leaves).sum(), leaves)
        runs[mode] = len(calls)
    assert runs == {"none": 1, remat: 2}
    for a, b in zip(grads["none"], grads[remat]):
        assert torch.equal(a, b)


def _bf16_split(x):
    """x as the kernels feed it to a bf16 product: hi = bf16(x) plus the
    bf16 rest lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _emulate_bf16_kernels(q, k, v, do, causal):
    """(out, lse, dq, dk, dv) as the bf16 tensor-core kernels compute
    them: products of bf16 operands added in f32, the scale applied to the
    f32 scores, an f32 softmax whose sum l is taken before rounding, P and
    dS rounded (``_bf16_split``) for P V, dS K, P^T dO and dS^T q, outputs
    rounded to bf16.  Delta reads the rounded out, as on the card."""
    B, S, H, d = q.shape
    G = H // k.shape[2]
    scale = d ** -0.5              # q and k are d wide, v may be narrower
    qf, dof = q.float(), do.float()
    kx, vx = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kx) * scale
    if causal:
        live = torch.ones(S, k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~live, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (torch.einsum("bhqk,bkhd->bhqd", _bf16_split(p), vx) / l
           ).transpose(1, 2).to(torch.bfloat16)
    lse = (m + torch.log(l)).squeeze(-1)
    P = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vx)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = _bf16_split(P * (dp - delta) * scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16_split(P), dof)
    dk, dv = (t.reshape(B, -1, H // G, G, t.shape[-1]).sum(3)
              for t in (dk, dv))
    return (out, lse) + tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _bar_ratio(a, b):
    """Largest |a - b| / (2e-2 (rms(b) + |b|)) and the norm-relative error:
    the card's bf16 bar holds where the first is <= 1, the second <= 1e-2."""
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    rms = b.square().mean().sqrt()
    return ((diff / (TOL["bfloat16"] * (rms + b.abs()))).max().item(),
            (diff.norm() / b.norm()).item())


def _emulated_vs_plain(S, H, hkv, d, causal, seed, dv=None):
    dv = dv or d
    q, k, v, do = (as_torch(x, "bfloat16") for x in draws(
        seed, (1, S, H, d), (1, S, hkv, d), (1, S, hkv, dv), (1, S, H, dv)))
    got = _emulate_bf16_kernels(q, k, v, do, causal)
    out, lse = TR.flash_fwd(q, k, v, causal=causal)
    want = (out, lse) + TR.flash_bwd(q, k, v, got[0], got[1], do,
                                     causal=causal)
    return got, want


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_rounding_within_bar(causal, G, d):
    """The bf16 kernels' roundings (hi + lo split of P and dS) against the
    plain versions, at S 273 (a ragged tail past 256): within the bar
    that ``chip_smoke.py`` and ``test_torch_cuda.py`` hold the card to;
    the forward also against the JAX package's naive oracle."""
    S, hkv = 273, 2
    got, want = _emulated_vs_plain(S, G * hkv, hkv, d, causal,
                                   seed=G * 10 + d)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        ratio, rel = _bar_ratio(a, b)
        assert ratio <= 1.0 and rel <= 1e-2, (name, ratio, rel)
    q, k, v = (as_jax(x, "bfloat16") for x in draws(
        G * 10 + d, (1, S, G * hkv, d), (1, S, hkv, d), (1, S, hkv, d)))
    naive = torch.from_numpy(np.asarray(
        JR.attention_naive(q, k, v, causal=causal), np.float32))
    ratio, rel = _bar_ratio(got[0], naive)
    assert ratio <= 1.0 and rel <= 1e-2, ("out vs JAX", ratio, rel)

