"""The port's flash attention (plain versions, which the CUDA kernels are
held against on the card) against the JAX package on the CPU.

* forward: against ``flash_attention_pallas(..., interpret=True)`` and
  ``ref.attention_naive`` on the shapes of ``tests/test_kernels.py``,
  2e-5 in f32 and 2e-2 in bf16 (the tolerances there);
* backward: the port's two-pass backward against ``jax.grad`` of the
  reference's ``flash_attention_blockwise`` (custom VJP), causal and
  not, atol 1e-4 / rtol 1e-3 as in ``test_kernels.py``;
* the ``FlashAttention`` autograd Function under ``gradcheck`` in f64,
  and recomputed correctly under both remat policies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
