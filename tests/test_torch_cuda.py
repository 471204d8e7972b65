"""The port's CUDA kernels against their plain PyTorch versions on the
card, over every head width and query-group size the decode kernel
takes and every stock enforcement program.  Marked ``cuda``: without a
card these tests skip.  On the card (no JAX there, so skip the JAX
conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import controller as C
from repro_torch.core import progs as P
from repro_torch.core import sched as S
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import enforcement as K

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hkv,d,s_max", [
    (2, 8, 4, 64, 256), (1, 4, 4, 32, 128), (3, 6, 2, 128, 192),
    (8, 24, 8, 128, 2048), (2, 8, 1, 64, 77), (4, 16, 2, 32, 513),
])
def test_decode_attention_kernel(dev, B, H, hkv, d, s_max, dtype):
    g = torch.Generator(device=dev).manual_seed(B * 1000 + s_max)
    q = torch.randn(B, H, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, s_max, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, s_max, hkv, d, generator=g, device=dev).to(dtype)
    lengths = torch.randint(0, s_max + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0] = s_max
    before = A.decode_attention.launches
    got = A.decode_attention(q, k, v, lengths)
    assert A.decode_attention.launches == before + 1
    want = A.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype]


def test_decode_attention_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 4, 80, device=dev)
    kv = torch.zeros(1, 16, 4, 80, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        A.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32,
                                                 device=dev))


def _table(rng, n, progs, dev):
    parent = np.full(n, -1, np.int32)
    for i in range(1, n):
        parent[i] = rng.integers(0, i) if i < 4 else rng.integers(1, i)
    depth = np.zeros(n, int)
    for i in range(1, n):
        depth[i] = depth[parent[i]] + 1
    parent[depth > 3] = 0
    st = C.new_state(200, n, progs, dev)
    st["parent"] = torch.from_numpy(parent).to(dev)
    st["high"] = torch.from_numpy(rng.integers(1, 40, n).astype(np.int32)
                                  ).to(dev)
    st["usage"] = torch.from_numpy(rng.integers(0, 45, n).astype(np.int32)
                                   ).to(dev)
    st["frozen"] = torch.from_numpy(rng.random(n) < 0.1).to(dev)
    st["prog_id"] = torch.from_numpy(
        rng.integers(0, len(progs), n).astype(np.int32)).to(dev)
    st["priority"] = torch.from_numpy(
        rng.integers(0, 3, n).astype(np.int32)).to(dev)
    return st


@pytest.mark.parametrize("kind", ["graduated", "token_bucket",
                                  "weighted_fair", "mixed"])
def test_enforcement_kernels_bit_exact(dev, kind):
    grad = P.GraduatedThrottleProgram()
    tb = P.TokenBucketProgram(bucket_capacity=4.0)
    wf = S.WeightedFairProgram()
    progs = {"graduated": (grad,), "token_bucket": (tb,),
             "weighted_fair": (wf,), "mixed": (grad, tb, wf)}[kind]
    rng = np.random.default_rng(len(kind))
    st = _table(rng, 40, progs, dev)
    for step in range(6):
        dom = torch.from_numpy(rng.integers(-1, 40, 8).astype(np.int32)
                               ).to(dev)
        amt = torch.from_numpy(rng.integers(0, 6, 8).astype(np.int32)
                               ).to(dev)
        got = K.fused_charge_batch(st, dom, amt, step, progs)
        want = C._plain_charge_batch(st, dom, amt, step, progs)
        for key in ("usage", "peak", "throttle_until", "mem_stall"):
            assert torch.equal(got[0][key], want[0][key]), key
        assert torch.equal(got[0]["prog"].view(torch.int32),
                           want[0]["prog"].view(torch.int32))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert torch.equal(K.fused_slot_gate(got[0], dom, step + 1, progs),
                           C._plain_slot_gate(got[0], dom, step + 1, progs))
        st = got[0]


def test_custom_program_raises_on_cuda(dev):
    class Custom(P.GraduatedThrottleProgram):
        pass

    st = C.new_state(100, 8, (Custom(),), dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="Custom"):
        C.charge_batch(st, one, one, 0, (Custom(),))
