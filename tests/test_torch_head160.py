"""Head dim 160 (pixtral-12b: 32 query heads over 8 kv heads) in the plain
versions that the decode and flash kernels are held against on the
card, against the JAX package's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them: the one-token decode at G 4 with
ragged lengths and an empty slot, dense and paged, and the flash forward
causal and full at a ragged S, f32 within 2e-5 and bf16 within 2e-2.
The bf16 kernels' roundings at d 160 (the decode's one rounding of P,
the flash forward's hi + lo split of P) hold the card's bars against the
plain versions, emulated on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as JR
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import flash_attention as FA
from test_torch_decode_attention import (SLOT_NORM_REL, emulate_bf16_kernel)
from test_torch_flash_attention import _bar_ratio, _emulated_vs_plain

D = 160
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(arrs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


def test_the_wrappers_take_d160():
    """d 160 is a width of the decode kernel and of the flash kernels,
    forward and backward (one set of (dk, dv) pairs for both passes)."""
    assert D in TD.HEAD_DIMS
    assert (D, D) in FA.HEAD_DIMS


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_pallas_d160(dtype):
    """G 4 over 2 kv heads, S_max 192, ragged lengths and an empty slot
    (the Pallas kernel and the port give it zeros)."""
    tol = DTYPES[dtype][2]
    B, H, hkv, smax = 4, 8, 2, 192
    (jq, jk, jv), (tq, tk, tv) = both(draws(
        160, (B, H, D), (B, smax, hkv, D), (B, smax, hkv, D)), dtype)
    lengths = np.array([0, 1, 77, 192], np.int32)
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths),
                                     block_s=64, interpret=True)
    got = TD.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.shape == (B, H, D) and got.dtype == tq.dtype
    close(got, pallas, tol)
    assert not got[0].float().any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_decode_plain_matches_pallas_d160(dtype):
    """16-token pages of a permuted pool, G 4, one slot filled."""
    tol = DTYPES[dtype][2]
    B, H, hkv, page, npp = 3, 8, 2, 16, 6
    n_pages = B * npp
    q, kp, vp = draws(161, (B, H, D), (n_pages, page, hkv, D),
                      (n_pages, page, hkv, D))
    table = np.random.default_rng(3).permutation(n_pages).reshape(
        B, npp).astype(np.int32)
    lengths = np.array([5, 96, 50], np.int32)
    (jq, jk, jv), (tq, tk, tv) = both((q, kp, vp), dtype)
    pallas = paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    got = TD.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lengths))
    close(got, pallas, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_plain_matches_pallas_d160(causal, dtype):
    """G 4 at S 200, which no 64- or 128-row tile of the card's kernels
    divides (the Pallas kernel runs 40-row blocks): out against the
    Pallas kernel and the naive oracle."""
    tol = DTYPES[dtype][2]
    B, S, H, hkv = 1, 200, 8, 2
    (jq, jk, jv), (tq, tk, tv) = both(draws(
        162, (B, S, H, D), (B, S, hkv, D), (B, S, hkv, D)), dtype)
    out, lse = FA.flash_fwd(tq, tk, tv, causal=causal)
    assert out.shape == (B, S, H, D) and lse.shape == (B, H, S)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=40,
                                    block_k=40, interpret=True)
    close(out, pallas, tol)
    close(out, JR.attention_naive(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("lengths,splits", [
    ([1, 2048, 37, 256, 257, 1000, 1555, 2047], 2),
    ([0, 1, 63, 64, 65, 700, 1999, 2048], 1),
])
def test_bf16_decode_roundings_hold_the_bar_d160(lengths, splits):
    """The bf16 decode kernel's one rounding of P at pixtral's G 4, d 160
    and the engine's 8 slots, S_max 2048: every element within 2e-2 and
    each live slot within SLOT_NORM_REL of the plain version."""
    B, H, hkv, S = 8, 16, 4, 2048
    rng = np.random.default_rng(S + splits)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16) for shape in
               ((B, H, D), (B, S, hkv, D), (B, S, hkv, D)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = emulate_bf16_kernel(q, k, v, lens, splits)
    want = TD.decode_attention_plain(q, k, v, lens)
    close(got, want.float().numpy(), DTYPES["bfloat16"][2])
    got, want = got.double().flatten(1), want.double().flatten(1)
    rel = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)
    assert rel[lens > 0].max().item() <= SLOT_NORM_REL
    assert not got[lens == 0].any()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_forward_roundings_hold_the_bar_d160(causal):
    """The bf16 flash forward's roundings (P split into bf16 hi + lo for
    P V) at d 160, G 4, a ragged S of 273: out and lse within the card's
    bf16 bar of the plain version."""
    got, want = _emulated_vs_plain(273, 8, 2, D, causal, seed=160)
    for name, a, b in zip(("out", "lse"), got[:2], want[:2]):
        ratio, rel = _bar_ratio(a, b)
        assert ratio <= 1.0 and rel <= 1e-2, (name, ratio, rel)
