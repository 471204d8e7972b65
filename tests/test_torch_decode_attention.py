"""The port's one-token GQA decode attention against the JAX package:
the plain torch version (what the wrapper runs on CPU tensors) and the
port's flash-decoding oracle against ``decode_attention_pallas`` in
interpret mode and ``ref.decode_attention_ref``, over the sweep of
``tests/test_kernels.py`` plus ragged ``S_max`` the Pallas kernel's
block assertion refuses; and the paged form against
``paged_decode_attention_pallas`` and ``ref.paged_decode_attention_ref``
at the parameters of ``tests/test_kernels.py``, with -1 table entries
past each length.  Tolerances as ``tests/test_kernels.py``: 2e-5 in f32,
2e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro_torch.kernels import decode_attention as TD
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

SWEEP = [(2, 8, 4, 64, 256), (1, 4, 4, 32, 128), (3, 6, 2, 128, 192)]
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
