"""The port's one-token GQA decode attention against the JAX package:
the plain torch version (what the wrapper runs on CPU tensors) and the
port's flash-decoding oracle against ``decode_attention_pallas`` in
interpret mode and ``ref.decode_attention_ref``, over the sweep of
``tests/test_kernels.py`` plus a group of 6 and ragged ``S_max`` the
Pallas kernel's block assertion refuses; the paged form against
``paged_decode_attention_pallas`` and ``ref.paged_decode_attention_ref``
at the parameters of ``tests/test_kernels.py`` and at groups of 3 and 6,
with -1 table entries past each length; and a CPU emulation of the bf16
kernel's roundings against the plain version, with a planted fault that
its bars must fail.  Tolerances as
``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as JR
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

SWEEP = [(2, 8, 4, 64, 256), (1, 4, 4, 32, 128), (3, 6, 2, 128, 192),
         (2, 12, 2, 64, 320)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(B, H, hkv, dk, Smax, seed):
    """Seeded numpy draws, rounded to the working dtype once so both
    packages see the same values."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dk), np.float32)
    kc = rng.standard_normal((B, Smax, hkv, dk), np.float32)
    vc = rng.standard_normal((B, Smax, hkv, dk), np.float32)
    return q, kc, vc


def both(arrs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,hkv,dk,Smax", SWEEP)
def test_plain_matches_pallas_and_ref(B, H, hkv, dk, Smax, dtype):
    tol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = both(inputs(B, H, hkv, dk, Smax, 4), dtype)
    lengths = np.arange(1, B + 1) * (Smax // (B + 1))
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths),
                                     block_s=64, interpret=True)
    oracle = JR.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                     block_s=64)
    tl = torch.from_numpy(lengths.astype(np.int32))
    plain = TD.decode_attention_plain(tq, tk, tv, tl)
    close(plain, pallas, tol)
    close(plain, oracle, tol)
    # the CPU route of the op entry point is the plain version, exactly
    assert torch.equal(TO.decode_attention(tq, tk, tv, tl), plain)
    close(TR.decode_attention_ref(tq, tk, tv, tl, block_s=64), oracle, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Smax", [1, 77, 250, 300])
def test_ragged_smax_and_edge_lengths(Smax, dtype):
    """``S_max`` that is no block multiple, lengths 0, 1 and ``S_max``:
    held against the Pallas kernel and the JAX oracle on the cache
    zero-padded to a block multiple (the padding lies past every
    length, so it is masked)."""
    tol = DTYPES[dtype][2]
    B, H, hkv, dk = 4, 24, 8, 32
    q, kc, vc = inputs(B, H, hkv, dk, Smax, 7)
    pad = -(-Smax // 64) * 64
    kp = np.zeros((B, pad, hkv, dk), np.float32)
    vp = np.zeros((B, pad, hkv, dk), np.float32)
    kp[:, :Smax], vp[:, :Smax] = kc, vc
    lengths = np.array([0, 1, max(1, Smax // 2), Smax], np.int32)
    (jq, jk, jv), _ = both((q, kp, vp), dtype)
    _, (tq, tk, tv) = both((q, kc, vc), dtype)
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths),
                                     block_s=64, interpret=True)
    oracle = JR.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                     block_s=64)
    got = TD.decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths))
    close(got, pallas, tol)
    # the oracle's -1e30 mask averages the values of an empty row; the
    # Pallas kernel (and the port) skip every block and give zeros
    close(got[1:], np.asarray(oracle)[1:], tol)
    assert not got[0].float().any()


def test_cpu_route_counts_no_launch():
    """The launch counter moves only where a kernel launches; CPU tensors
    take the plain version."""
    q, kc, vc = inputs(1, 4, 4, 32, 16, 1)
    before = TD.decode_attention.launches
    TD.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                        torch.from_numpy(vc),
                        torch.tensor([5], dtype=torch.int32))
    assert TD.decode_attention.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("page,npp,dv", [(16, 8, 64), (32, 4, 64),
                                         (16, 8, 32)])
def test_paged_plain_matches_pallas_and_ref(page, npp, dv, dtype):
    """``tests/test_kernels.py``'s pools (B=2, H=8, Hkv=4, dk=64, 64
    pages, a permutation as the table) in both dtypes, and v narrower
    than k.  The Pallas kernel loads a page for every table entry, so it
    gets the whole permutation; the port gets -1 past each length and
    must never read those entries."""
    tol = DTYPES[dtype][2]
    B, H, hkv, dk, n_pages = 2, 8, 4, 64, 64
    rng = np.random.default_rng(page + dv)
    q = rng.standard_normal((B, H, dk), np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, dk), np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, dv), np.float32)
    table = rng.permutation(n_pages)[:B * npp].reshape(B, npp).astype(
        np.int32)
    lengths = np.array([page * npp // 2 + 3, page * npp], np.int32)
    live = np.arange(npp)[None] * page < lengths[:, None]
    holey = np.where(live, table, -1).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = both((q, kp, vp), dtype)
    pallas = paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    oracle = JR.paged_decode_attention_ref(jq, jk, jv, jnp.asarray(table),
                                           jnp.asarray(lengths))
    tl, tt = torch.from_numpy(lengths), torch.from_numpy(holey)
    plain = TD.paged_decode_attention_plain(tq, tk, tv, tt, tl)
    close(plain, pallas, tol)
    close(plain, oracle, tol)
    assert torch.equal(TO.paged_decode_attention(tq, tk, tv, tt, tl), plain)
    close(TR.paged_decode_attention_ref(tq, tk, tv, tt, tl), oracle, tol)


def test_paged_empty_slot_is_zero():
    """A slot of length 0 reads no page at all (its whole row is -1) and
    gives zeros, as the dense kernel does."""
    q, kp, vp = inputs(2, 4, 2, 32, 16, 3)
    table = torch.tensor([[-1, -1], [0, 1]], dtype=torch.int32)
    got = TD.paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp[:, :8]),
        torch.from_numpy(vp[:, :8]), table,
        torch.tensor([0, 12], dtype=torch.int32))
    assert not got[0].any() and got[1].abs().sum() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,hkv", [(6, 2), (12, 2)])
def test_paged_plain_matches_pallas_group_not_power_of_two(H, hkv, dtype):
    """Groups of 3 and 6 query heads a kv head over a permuted pool of
    16-token pages, ragged lengths (one inside the first page, one a
    whole number of pages), -1 past each length for the port."""
    tol = DTYPES[dtype][2]
    B, dk, page, npp, n_pages = 3, 64, 16, 6, 24
    rng = np.random.default_rng(H)
    q = rng.standard_normal((B, H, dk), np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, dk), np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, dk), np.float32)
    table = rng.permutation(n_pages)[:B * npp].reshape(B, npp).astype(
        np.int32)
    lengths = np.array([37, 96, 1], np.int32)
    live = np.arange(npp)[None] * page < lengths[:, None]
    holey = np.where(live, table, -1).astype(np.int32)
    (jq, jk, jv), (tq, tk, tv) = both((q, kp, vp), dtype)
    pallas = paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    plain = TD.paged_decode_attention_plain(
        tq, tk, tv, torch.from_numpy(holey), torch.from_numpy(lengths))
    close(plain, pallas, tol)


LOG2E = 1.4426950408889634
# the bf16 decode kernel's bar for each live slot, norm-relative, as on
# the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)
SLOT_NORM_REL = 1e-2


def emulate_bf16_kernel(q, k, v, lengths, splits, drop=None):
    """What the bf16 kernel (``csrc/decode_attention.cu``,
    ``decode_mma_kernel``) computes, with its roundings, in f32 on the
    CPU: a slot's live 64-key tiles split evenly over ``splits`` CTAs,
    each tile's keys 16 to each of 4 warps; each warp keeps an online
    softmax in log2 units over its keys, rounds P once to bf16 before
    P V and sums the rounded P into l; warps, then CTAs, merge in f32;
    out is rounded once to bf16.  q, k and v are exact in bf16, so S
    carries only f32 rounding.  ``drop``: a CTA whose tiles are skipped
    (a planted fault)."""
    B, H, dk = q.shape
    S, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // hkv
    c = dk ** -0.5 * LOG2E
    out = torch.zeros(B, H, dv)
    for b in range(B):
        n = min(int(lengths[b]), S)
        per = -(-(-(-n // 64)) // splits)     # tiles a CTA
        if per == 0:
            continue
        keys = splits * per * 64
        kp = torch.zeros(keys, hkv, dk)
        vp = torch.zeros(keys, hkv, dv)
        kp[:n], vp[:n] = k[b, :n].float(), v[b, :n].float()
        # (CTA, tile, warp, key) -> the key's position
        kr = kp.reshape(splits, per, 4, 16, hkv, dk)
        vr = vp.reshape(splits, per, 4, 16, hkv, dv)
        s = torch.einsum("hgd,rtwkhd->hgrtwk",
                         q[b].float().reshape(hkv, G, dk), kr) * c
        pos = torch.arange(keys).reshape(splits, per, 4, 16)
        s = torch.where(pos < n, s, torch.tensor(-math.inf))
        if drop is not None:
            s[:, :, drop] = -math.inf
        m = torch.full((hkv, G, splits, 4), -math.inf)
        l = torch.zeros(hkv, G, splits, 4)
        acc = torch.zeros(hkv, G, splits, 4, dv)
        for i in range(per):
            m_new = torch.maximum(m, s[:, :, :, i].amax(-1))
            base = torch.where(torch.isinf(m_new), 0.0, m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s[:, :, :, i] - base[..., None]).to(
                torch.bfloat16).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "hgrwk,rwkhe->hgrwe", p, vr[:, i])
            m = m_new
        m, l = m.reshape(hkv, G, -1), l.reshape(hkv, G, -1)
        acc = acc.reshape(hkv, G, -1, dv)
        top = m.amax(-1, keepdim=True)
        w = torch.exp2(m - torch.where(torch.isinf(top), 0.0, top))
        o = (acc * w[..., None]).sum(2) / (l * w).sum(-1).clamp(
            min=1e-30)[..., None]
        out[b] = o.reshape(H, dv)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("B,H,hkv,d,S,lengths,splits", [
    (8, 24, 8, 128, 2048, [1, 2048, 37, 256, 257, 1000, 1555, 2047], 4),
    (3, 12, 2, 64, 32768, [32768, 20001, 1], 8),
    (8, 16, 2, 32, 320, [0, 1, 2, 63, 64, 65, 129, 320], 1),
    (8, 16, 2, 32, 320, [0, 1, 2, 63, 64, 65, 129, 320], 8),
])
def test_bf16_kernel_roundings_hold_the_bar(B, H, hkv, d, S, lengths,
                                            splits):
    """One bf16 rounding of P (the kernel's choice; the flash kernels'
    hi + lo split is not needed here) keeps the emulated kernel within
    the bf16 bars of the plain version: 2e-2 for every element and
    SLOT_NORM_REL norm-relative for every live slot (the absolute bar
    alone is as large as a slot's values at 32768 keys, |out| ~ sqrt(e /
    n)), at the filled serving shape, at S 32768 and at short lengths
    where few keys share the weight, with zeros for an empty slot."""
    rng = np.random.default_rng(S + splits)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16) for shape in
               ((B, H, d), (B, S, hkv, d), (B, S, hkv, d)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = emulate_bf16_kernel(q, k, v, lens, splits)
    want = TD.decode_attention_plain(q, k, v, lens)
    close(got, want.float().numpy(), DTYPES["bfloat16"][2])
    got, want = got.double().flatten(1), want.double().flatten(1)
    rel = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)
    assert rel[lens > 0].max().item() <= SLOT_NORM_REL
    assert not got[lens == 0].any()


def test_slot_bar_fails_a_dropped_share():
    """The bars can fail a wrong kernel: with one of 8 CTAs' shares of a
    slot skipped at S 32768, every element still lies within the
    absolute bar of 2e-2 (|out| is ~0.01 there), and the slot's
    norm-relative error misses SLOT_NORM_REL."""
    B, H, hkv, d, S = 3, 12, 2, 64, 32768
    rng = np.random.default_rng(S + 8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16) for shape in
               ((B, H, d), (B, S, hkv, d), (B, S, hkv, d)))
    lens = torch.tensor([32768, 20001, 1], dtype=torch.int32)
    got = emulate_bf16_kernel(q, k, v, lens, 8, drop=1).double().flatten(1)
    want = TD.decode_attention_plain(q, k, v, lens).double().flatten(1)
    assert (got - want).abs().max().item() <= DTYPES["bfloat16"][2]
    rel = (got - want).norm(dim=1) / want.norm(dim=1)
    assert rel.max().item() > SLOT_NORM_REL
