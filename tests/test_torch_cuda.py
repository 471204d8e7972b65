"""The port's CUDA kernels against their plain PyTorch versions on the
card, over every head width and query-group size the decode and flash
kernels take (d 160: the decode kernel at every cluster size and both
flash passes; MLA's dk 192 / dv 128 in both flash passes; a pair the
flash kernels do not take refused before any launch), the
decode kernel's edge lengths and its one launch a
call, the paged decode's page sizes and unequal k/v widths, the
SSD scan's chunk, state and head widths, and every stock enforcement
program over random tables and the engine-shaped ones of
``kernels/enforcement_bench.py`` up to n 20,008, with and without the
sharded backend's leading shard axis; and the serving engine's step
replayed as one CUDA graph against its eager step.  Marked ``cuda``:
without a
card these tests skip.  On the card (no JAX there, so skip the JAX
conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.core import controller as C
from repro_torch.core import progs as P
from repro_torch.core import sched as S
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import enforcement as K
from repro_torch.kernels import enforcement_bench as EB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ref as R

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the decode kernels' bar for each live slot, norm-relative: a slot of n
# live keys has |out| near sqrt(e / n), ~0.01 at 32768 keys, so TOL alone
# would pass a slot that lost a CTA's share of its keys
SLOT_NORM_REL = 1e-2


def slot_norm_rel(got, want, lengths) -> float:
    """The largest ||got_b - want_b|| / ||want_b|| over the live slots b."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    rel = (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)
    return rel[lengths > 0].max().item()


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
    (2, 10, 2, 64, 300), (2, 12, 2, 128, 1000), (3, 14, 2, 32, 129),
    (2, 8, 8, 128, 64), (1, 24, 8, 128, 32768),
    # the decoder families' heads at the engine's slots: minicpm (G 1 at
    # d 64 over 36 kv heads), phi3 (G 4 over 10), maverick (G 5),
    # internlm2 (G 6)
    (8, 36, 36, 64, 2048), (8, 40, 10, 128, 2048), (8, 40, 8, 128, 2048),
    (8, 48, 8, 128, 2048),
    # pixtral-12b's heads (G 4 at d 160) at the engine's slots, a ragged
    # S_max, and S_max 32768
    (8, 32, 8, 160, 2048), (3, 12, 3, 160, 1001), (1, 32, 8, 160, 32768),
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
    assert slot_norm_rel(got, want, lengths) <= SLOT_NORM_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_edge_lengths(dev, dtype):
    """Lengths 0, 1, 63, 64, 65, on and beside the boundaries of the bf16
    kernel's CTA shares, and S_max = 2055, no multiple of 64: each slot
    against the plain version, an empty slot exactly 0.  bf16 runs at
    every cluster size (1, 2, 4 and 8 CTAs a slot and kv head: a slot of
    2048 keys gives each CTA 2048, 1024, 512 or 256, one of 257 gives
    five tiles as 5, 3+2, 2+2+1+0 or 1+1+1+1+1+0+0+0) as well as at
    ``_splits``'s choice."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, hkv, d, s_max = 12, 16, 2, 64, 2055
    q = torch.randn(B, H, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, s_max, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, s_max, hkv, d, generator=g, device=dev).to(dtype)
    lengths = torch.tensor([0, 1, 63, 64, 65, 255, 256, 257, 1024, 2048,
                            2049, 2055], dtype=torch.int32, device=dev)
    want = A.decode_attention_plain(q, k, v, lengths)
    runs = [A.decode_attention(q, k, v, lengths)]
    if dtype == torch.bfloat16:
        runs += [A._run(q, k, v, None, lengths, s_max, 0, d, None,
                        "decode_attention", splits=n) for n in (1, 2, 4, 8)]
    torch.cuda.synchronize()
    for got in runs:
        assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
        assert slot_norm_rel(got, want, lengths) <= SLOT_NORM_REL
        assert not got[0].float().any()


def test_bf16_decode_is_one_kernel_and_one_allocation(dev):
    """A bf16 call, dense or paged, runs exactly one kernel (the
    profiler's count) and allocates only its output."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(8, 24, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(8, 256, 8, 128, generator=g, device=dev).to(
        torch.bfloat16)
    lengths = torch.tensor([1, 256, 37, 100, 0, 64, 65, 200],
                           dtype=torch.int32, device=dev)
    table = torch.arange(8 * 16, dtype=torch.int32, device=dev).reshape(8, 16)
    pool = k.reshape(8 * 16, 16, 8, 128)
    calls = {"dense": lambda: A.decode_attention(q, k, k, lengths),
             "paged": lambda: A.paged_decode_attention(q, pool, pool, table,
                                                       lengths)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        after = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kernels) == 1, (name, kernels)
        assert "decode_mma_kernel" in kernels[0].key, name
        assert after - before == 1, name


def test_decode_attention_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 4, 80, device=dev)
    kv = torch.zeros(1, 16, 4, 80, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        A.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32,
                                                 device=dev))


def test_decode_d160_edge_lengths(dev):
    """bf16 at d 160 (pixtral's heads) holds the bars at every cluster
    size, on and beside the CTA shares' boundaries."""
    g = torch.Generator(device=dev).manual_seed(163)
    B, H, hkv, d, s_max = 8, 32, 8, 160, 2055
    q = torch.randn(B, H, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, s_max, hkv, d, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([0, 1, 63, 64, 65, 1024, 2049, 2055],
                           dtype=torch.int32, device=dev)
    want = A.decode_attention_plain(q, k, v, lengths)
    for n in (1, 2, 4, 8):
        got = A._run(q, k, v, None, lengths, s_max, 0, d, None,
                     "decode_attention", splits=n)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= TOL[
            torch.bfloat16]
        assert slot_norm_rel(got, want, lengths) <= SLOT_NORM_REL
        assert not got[0].float().any()


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


ENGINE_OPTIONS = {
    "negative_dup": dict(negative=True, dup=True, peak_below=True,
                         prog_oob=True),
    "ancestor": dict(ancestor=True, peak_below=True),
    "empty": dict(),
}


def _same_charge(got, want) -> bool:
    return (EB.same_tables(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2]))


@pytest.mark.parametrize("option", list(ENGINE_OPTIONS))
@pytest.mark.parametrize("kind", ["graduated", "token_bucket",
                                  "weighted_fair", "mixed"])
@pytest.mark.parametrize("slots", [8, 256, 1024])
def test_enforcement_kernels_engine_shaped(dev, slots, kind, option):
    """The bench's tables (n = 4 slots + 8: 40, 1,032, 4,104; the last
    past what a whole-table staging fits in shared memory) with negative
    amounts, duplicates, peaks under usage, program ids out of range,
    the in-batch ancestor throttle and m = 0: the charge and then the
    gate bit-exact."""
    progs = EB.registries()[kind]
    st, dom, amt, step = EB.engine_case(slots, progs, slots + len(kind),
                                        dev, **ENGINE_OPTIONS[option])
    if option == "empty":
        dom, amt = dom[:0], amt[:0]
    got = K.fused_charge_batch(st, dom, amt, step, progs)
    want = C._plain_charge_batch(st, dom, amt, step, progs)
    torch.cuda.synchronize()
    assert _same_charge(got, want)
    if option == "ancestor":
        assert bool(want[1][0]) and not bool(want[1][1])
    assert torch.equal(K.fused_slot_gate(got[0], dom, step + 1, progs),
                       C._plain_slot_gate(got[0], dom, step + 1, progs))


@pytest.mark.parametrize("slots,m", [(2048, 8), (5000, 600), (2, 257)])
def test_charge_takes_any_table_size(dev, slots, m):
    """Tables copied by several CTAs (n 8,200 and 20,008) and batches
    over one chunk of 256 slots (600, ragged; 257 on a 16-domain table,
    every domain charged many times)."""
    progs = EB.registries()["mixed"]
    st, dom, amt, step = EB.engine_case(slots, progs, m, dev, negative=True,
                                        dup=True)
    g = torch.Generator(device=dev).manual_seed(m)
    pick = torch.randint(0, dom.shape[0], (m,), generator=g, device=dev)
    dom, amt = dom[pick].contiguous(), amt[pick].contiguous()
    got = K.fused_charge_batch(st, dom, amt, step, progs)
    want = C._plain_charge_batch(st, dom, amt, step, progs)
    torch.cuda.synchronize()
    assert _same_charge(got, want)


def _graph_nodes(call) -> list:
    """The node types of a CUDA graph that captures one ``call()``: each
    kernel the call launches is a kernel node (type 0), a fill or a copy
    another type.  (The profiler's trace came back with no event now and
    then for these ~3-8 µs kernels in whole-file runs on the card, so it
    cannot count them.)"""
    import ctypes

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        call()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def test_charge_is_one_kernel_and_one_allocation(dev):
    """A charge launches one kernel (the nodes of a CUDA graph capturing
    it) and allocates one buffer; a gate one kernel and its output."""
    progs = EB.registries()["graduated"]
    st, dom, amt, step = EB.engine_case(8, progs, 0, dev)
    calls = {"charge": lambda: K.fused_charge_batch(st, dom, amt, step,
                                                    progs),
             "gate": lambda: K.fused_slot_gate(st, dom, step, progs)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        call()
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        assert after - before == 1, name
        assert _graph_nodes(call) == [0], name


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("shape", list(EB.SHARD_SHAPES))
def test_shard_axis_charge_and_gate_bit_exact(dev, shape, shards):
    """The shard axis over the bench's shard shapes (and their first
    shard alone, S 1 with the axis), three steps feeding forward: the
    charge and the gate bit-exact against the plain per-shard loop, and
    each call one launch on the counters."""
    st, dom, amt, step, progs = EB.shard_case(shape, dev, shards)
    st = {k: v[:shards].contiguous() for k, v in st.items()}
    dom = dom[:shards].contiguous()
    for _ in range(3):
        before = (K.fused_charge_batch.launches, K.fused_slot_gate.launches)
        got = K.fused_charge_batch(st, dom, amt, step, progs)
        gate = K.fused_slot_gate(got[0], dom, step + 1, progs)
        assert (K.fused_charge_batch.launches - before[0],
                K.fused_slot_gate.launches - before[1]) == (1, 1)
        want = C._plain_charge_shards(st, dom, amt, step, progs)
        torch.cuda.synchronize()
        assert got[1].shape == (shards, dom.shape[1])
        assert _same_charge(got, want)
        assert torch.equal(gate, C._plain_gate_shards(got[0], dom, step + 1,
                                                      progs))
        st = dict(st, **{k: got[0][k] for k in EB.STATE_KEYS})
        step += 1


def test_shard_axis_is_one_kernel_and_s1_the_device_call(dev):
    """At any S a charge and a gate are one kernel node; at S 1 the call
    with the axis gives the call without it, bit for bit."""
    st, dom, amt, step, progs = EB.shard_case("groups", dev)
    for call in (lambda: K.fused_charge_batch(st, dom, amt, step, progs),
                 lambda: K.fused_slot_gate(st, dom, step, progs)):
        call()
        torch.cuda.synchronize()
        assert _graph_nodes(call) == [0]
    one = {k: v[0] for k, v in st.items()}
    flat = K.fused_charge_batch(one, dom[0], amt, step, progs)
    axis = K.fused_charge_batch({k: v[:1] for k, v in st.items()},
                                dom[:1], amt, step, progs)
    assert EB.same_tables(flat[0], {k: v[0] for k, v in axis[0].items()
                                    if k in EB.STATE_KEYS})
    assert torch.equal(flat[1], axis[1][0]) and torch.equal(flat[2],
                                                            axis[2][0])
    assert torch.equal(K.fused_slot_gate(one, dom[0], step, progs),
                       K.fused_slot_gate({k: v[:1] for k, v in st.items()},
                                         dom[:1], step, progs)[0])


def test_enforcement_refuses_what_it_cannot_take(dev):
    progs = EB.registries()["graduated"]
    st, dom, amt, step = EB.engine_case(8, progs, 0, dev)
    with pytest.raises(ValueError, match="amt"):
        K.fused_charge_batch(st, dom, amt.long(), step, progs)
    with pytest.raises(ValueError, match="usage"):
        K.fused_charge_batch(dict(st, usage=st["usage"].cpu()), dom, amt,
                             step, progs)
    with pytest.raises(ValueError, match="throttle_until"):
        K.fused_slot_gate(dict(st, throttle_until=st["throttle_until"][:5]),
                          dom, step, progs)


def test_custom_program_raises_on_cuda(dev):
    class Custom(P.GraduatedThrottleProgram):
        pass

    st = C.new_state(100, 8, (Custom(),), dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="Custom"):
        C.charge_batch(st, one, one, 0, (Custom(),))


FLASH_SHAPES = [  # B, S, Sk, H, Hkv, d, causal
    (1, 128, 128, 4, 4, 32, True), (2, 256, 256, 8, 2, 64, True),
    (1, 128, 128, 6, 2, 80, False), (2, 192, 192, 4, 1, 64, True),
    (1, 1000, 1000, 8, 2, 128, True), (2, 77, 131, 4, 2, 128, False),
    (1, 131, 77, 4, 4, 64, True), (1, 64, 64, 24, 8, 128, True),
    # sequences shorter than one 128-row box, MHA and MQA, causal with
    # S != Sk both ways, and every head dim in the causal cross case
    (2, 50, 50, 4, 2, 128, True), (1, 33, 200, 8, 8, 64, False),
    (1, 300, 500, 6, 2, 80, True), (1, 500, 300, 4, 1, 32, True),
    (2, 200, 333, 6, 3, 128, True), (1, 260, 140, 3, 3, 64, True),
    # the decoder families' heads: minicpm, phi3, maverick, internlm2
    (1, 512, 512, 36, 36, 64, True), (1, 512, 512, 40, 10, 128, True),
    (1, 512, 512, 40, 8, 128, True), (1, 512, 512, 48, 8, 128, True),
    # hubert-xlarge's: MHA at d 80, bidirectional
    (1, 512, 512, 16, 16, 80, False),
    # pixtral-12b's d 160 (the paired dk/dv kernel): G 4, causal and
    # full, tails, S != Sk, one tile
    (1, 512, 512, 32, 8, 160, True), (2, 333, 333, 8, 2, 160, False),
    (1, 1000, 1000, 8, 2, 160, True), (1, 200, 333, 4, 1, 160, True),
    (1, 128, 128, 1, 1, 160, False),
    # deepseek-v2's MLA, (dk, dv) = (192, 128): G 1 (its H = Hkv) and G
    # 4, causal and full, S < 128, S != Sk both ways
    (1, 512, 512, 8, 8, (192, 128), True),
    (2, 333, 333, 8, 2, (192, 128), False),
    (2, 50, 50, 4, 1, (192, 128), True),
    (1, 200, 333, 4, 4, (192, 128), True),
    (1, 333, 200, 8, 2, (192, 128), False),
    (1, 1000, 1000, 16, 16, (192, 128), True),
]
# the forward alone at d 160 (pixtral-12b's prefill): G 4, causal and
# full, tails in both, S != Sk, one tile
FLASH_FWD_SHAPES = [  # B, S, Sk, H, Hkv, d, causal
    (1, 512, 512, 32, 8, 160, True), (2, 333, 333, 8, 2, 160, False),
    (1, 1000, 1000, 8, 2, 160, True), (1, 200, 333, 4, 1, 160, True),
    (1, 128, 128, 1, 1, 160, False),
]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_one_tile(dev, causal):
    """The bf16 forward on one 128 x 128 tile (S 128, one head): the
    wgmma descriptors, the TMA swizzle and the fragment order, before any
    loop over key tiles."""
    g = torch.Generator(device=dev).manual_seed(128)
    q, k, v = (torch.randn(1, 128, 1, 128, generator=g, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    want_out, want_lse = R.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (lse - want_lse).abs().max().item() <= 2e-2
    diff = (out.double() - want_out.double()).abs()
    rms = want_out.double().square().mean().sqrt()
    assert (diff <= 2e-2 * (rms + want_out.double().abs())).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,H,hkv,d,causal", FLASH_SHAPES)
def test_flash_kernels(dev, B, S, Sk, H, hkv, d, causal, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) against the plain
    versions b on the same inputs: every element within 2e-5 (1 + |b|)
    in f32; in bf16 within 2e-2 (rms(b) + |b|), and 1e-2 norm-relative
    (one bf16 rounding of a large gradient passes, a wrong small value
    does not).  ``d`` is a head dim, or a (dk, dv) pair."""
    _flash_both_passes(dev, B, S, Sk, H, hkv, d, causal, dtype)


def _flash_both_passes(dev, B, S, Sk, H, hkv, d, causal, dtype):
    dk, dv = d if isinstance(d, tuple) else (d, d)
    g = torch.Generator(device=dev).manual_seed(
        S * 7 + Sk + dk + (0 if dv == dk else dv))
    q = torch.randn(B, S, H, dk, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, hkv, dk, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, hkv, dv, generator=g, device=dev).to(dtype)
    do = torch.randn(B, S, H, dv, generator=g, device=dev).to(dtype)
    before = (FA.flash_fwd.launches, FA.flash_bwd.launches)
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    grads = FA.flash_bwd(q, k, v, out, lse, do, causal=causal)
    assert (FA.flash_fwd.launches, FA.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_lse = R.flash_fwd(q, k, v, causal=causal)
    want = R.flash_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse) + tuple(grads),
                          (want_out, want_lse) + tuple(want)):
        a, b = a.double(), b.double()
        diff = (a - b).abs()
        if dtype == torch.float32:
            assert (diff <= tol * (1 + b.abs())).all(), name
        else:
            rms = b.square().mean().sqrt()
            assert (diff <= tol * (rms + b.abs())).all(), name
            assert diff.norm() <= 1e-2 * b.norm(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Sk,H,hkv,d,causal", FLASH_FWD_SHAPES)
def test_flash_forward_kernel(dev, B, S, Sk, H, hkv, d, causal, dtype):
    """The forward (out, lse) against the plain version b under
    ``test_flash_kernels``' bars."""
    g = torch.Generator(device=dev).manual_seed(S * 7 + Sk + d)
    q = torch.randn(B, S, H, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Sk, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Sk, hkv, d, generator=g, device=dev).to(dtype)
    before = FA.flash_fwd.launches
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    assert FA.flash_fwd.launches == before + 1
    want_out, want_lse = R.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    for name, a, b in (("out", out, want_out), ("lse", lse, want_lse)):
        a, b = a.double(), b.double()
        diff = (a - b).abs()
        if dtype == torch.float32:
            assert (diff <= tol * (1 + b.abs())).all(), name
        else:
            rms = b.square().mean().sqrt()
            assert (diff <= tol * (rms + b.abs())).all(), name
            assert diff.norm() <= 1e-2 * b.norm(), name


def test_flash_d160_backward_refused_before_any_launch(dev):
    """d 160 trains on the card: ``flash_attention`` with a gradient to
    come runs one forward and one backward launch, and its gradients
    match the plain versions' under the bf16 bars; the forward alone
    still runs under no_grad."""
    g = torch.Generator(device=dev).manual_seed(160)
    q, k, v, do = (torch.randn(1, 300, h, 160, generator=g, device=dev
                               ).to(torch.bfloat16) for h in (8, 2, 2, 8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _, lse = FA.flash_fwd(q, k, v)       # the lse the Function saves
    before = (FA.flash_fwd.launches, FA.flash_bwd.launches)
    out = FA.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    assert (FA.flash_fwd.launches, FA.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_out, _ = R.flash_fwd(q, k, v)
    want = R.flash_bwd(q, k, v, out.detach(), lse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                          (want_out,) + tuple(want)):
        a, b = a.detach().double(), b.double()
        diff = (a - b).abs()
        rms = b.square().mean().sqrt()
        assert (diff <= TOL[torch.bfloat16] * (rms + b.abs())).all(), name
        assert diff.norm() <= 1e-2 * b.norm(), name
    with torch.no_grad():
        out = FA.flash_attention(*leaves)
    assert out.shape == q.shape and FA.flash_fwd.launches == before[0] + 2


def test_flash_function_matches_plain_autograd(dev):
    """The autograd Function on the card against the same Function on the
    CPU (plain versions) through a loss, f32."""
    rng = np.random.default_rng(5)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 96, 6, 64), (2, 96, 2, 64), (2, 96, 2, 64),
                            (2, 96, 6, 64)))
    grads = {}
    for where in ("cpu", dev):
        leaves = [t.to(where).requires_grad_() for t in (q, k, v)]
        loss = (FA.flash_attention(*leaves, causal=True) * w.to(where)).sum()
        grads[str(where)] = [x.cpu() for x in
                             torch.autograd.grad(loss, leaves)]
    for a, b in zip(grads["cpu"], grads[str(dev)]):
        assert (a - b).abs().max().item() <= 2e-5 * max(1.0, a.abs().max())


def test_flash_refuses_what_it_cannot_take(dev):
    """A head dim outside the kernels' pairs, and the reduced deepseek's
    (dk, dv) = (48, 32), are refused before any launch in both passes."""
    before = (FA.flash_fwd.launches, FA.flash_bwd.launches)
    q = torch.zeros(1, 16, 4, 96, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd(q, q, q)
    q = torch.zeros(1, 16, 4, 48, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(1, 16, 4, 32, device=dev, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 16, device=dev)
    with pytest.raises(ValueError, match=r"\(dk 48, dv 32\)"):
        FA.flash_fwd(q, q, v)
    with pytest.raises(ValueError, match=r"\(dk 48, dv 32\)"):
        FA.flash_bwd(q, q, v, v, lse, v)
    assert (FA.flash_fwd.launches, FA.flash_bwd.launches) == before
    q = torch.zeros(1, 16, 4, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hkv,dk,dv,page,npp", [
    (2, 8, 4, 64, 64, 16, 8), (2, 8, 4, 64, 64, 32, 4),
    (8, 24, 8, 128, 128, 16, 128), (3, 6, 2, 32, 32, 16, 5),
    (2, 8, 1, 128, 64, 32, 6), (4, 16, 2, 64, 128, 16, 40),
    (2, 7, 1, 32, 128, 32, 9), (2, 10, 2, 128, 32, 16, 33),
    (8, 32, 8, 160, 160, 16, 128), (3, 12, 3, 160, 160, 32, 9),
])
def test_paged_decode_kernel(dev, B, H, hkv, dk, dv, page, npp, dtype):
    """A permuted pool, -1 past each length (never read), one empty slot
    and one full slot."""
    g = torch.Generator(device=dev).manual_seed(B * 100 + npp + dv)
    n_pages = B * npp + 3
    q = torch.randn(B, H, dk, generator=g, device=dev).to(dtype)
    kp = torch.randn(n_pages, page, hkv, dk, generator=g,
                     device=dev).to(dtype)
    vp = torch.randn(n_pages, page, hkv, dv, generator=g,
                     device=dev).to(dtype)
    lengths = torch.randint(1, npp * page + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 0, npp * page
    table = torch.randperm(n_pages, generator=g, device=dev)[:B * npp]
    table = table.reshape(B, npp).to(torch.int32)
    first = torch.arange(npp, device=dev)[None] * page
    table = torch.where(first < lengths[:, None], table,
                        torch.full_like(table, -1))
    before = A.paged_decode_attention.launches
    got = A.paged_decode_attention(q, kp, vp, table, lengths)
    assert A.paged_decode_attention.launches == before + 1
    want = A.paged_decode_attention_plain(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert slot_norm_rel(got, want, lengths) <= SLOT_NORM_REL
    assert not got[0].float().any()


SSD_SHAPES = [  # b, s, nh, dh, N, chunk
    (1, 128, 2, 32, 16, 32), (2, 64, 4, 16, 8, 64), (1, 96, 1, 64, 4, 32),
    (1, 512, 2, 64, 16, 256), (2, 256, 3, 80, 16, 128),
    (1, 1024, 8, 1024, 16, 256), (1, 96, 2, 200, 12, 96),
    (1, 100, 2, 64, 16, 100), (1, 64, 2, 36, 8, 32),
]


def _ssd_check(dev, b, s, nh, dh, N, chunk, dtype, dt_scale=1.0):
    """y within 5e-4 (1 + |b|) in f32, and in bf16 within 2e-2 (rms(b) +
    |b|) and 1e-2 norm-relative; the f32 h_final within 5e-4 (1 + |b|);
    B and C strided views of one projection."""
    g = torch.Generator(device=dev).manual_seed(s + dh + N)
    x = torch.randn(b, s, nh, dh, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, s, nh, generator=g,
                                                  device=dev)) * dt_scale
    A_ = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.5)
    bc = torch.randn(b, s, 2 * N, generator=g, device=dev).to(dtype)
    D = torch.randn(nh, generator=g, device=dev)
    before = MS.ssd_scan.launches
    y, h = MS.ssd_scan(x, dt, A_, bc[..., :N], bc[..., N:], D, chunk=chunk)
    assert MS.ssd_scan.launches == before + 1
    wy, wh = MS.ssd_plain(x, dt, A_, bc[..., :N], bc[..., N:], D,
                          chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    for a, w, dt_ in ((y, wy, dtype), (h, wh, torch.float32)):
        a, w = a.double(), w.double()
        diff = (a - w).abs()
        if dt_ == torch.float32:
            assert (diff <= 5e-4 * (1 + w.abs())).all()
        else:
            rms = w.square().mean().sqrt()
            assert (diff <= 2e-2 * (rms + w.abs())).all()
            assert diff.norm() <= 1e-2 * w.norm()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,dh,N,chunk", SSD_SHAPES)
def test_ssd_kernel(dev, b, s, nh, dh, N, chunk, dtype):
    _ssd_check(dev, b, s, nh, dh, N, chunk, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_steep_decay(dev, dtype):
    """dt x 4: seg spans hundreds over a chunk of 256, so exp above the
    diagonal would overflow many times over."""
    _ssd_check(dev, 1, 512, 4, 128, 16, 256, dtype, dt_scale=4.0)


def test_ssd_refuses_what_it_cannot_take(dev):
    x = torch.zeros(1, 64, 1, 16, device=dev)
    dt = torch.zeros(1, 64, 1, device=dev)
    one = torch.ones(1, device=dev)
    with pytest.raises(ValueError, match="states up to N=16"):
        MS.ssd_scan(x, dt, one, torch.zeros(1, 64, 32, device=dev),
                    torch.zeros(1, 64, 32, device=dev), one, chunk=64)
    with pytest.raises(NotImplementedError, match="no gradient"):
        MS.ssd_scan(x.requires_grad_(), dt, one,
                    torch.zeros(1, 64, 8, device=dev),
                    torch.zeros(1, 64, 8, device=dev), one, chunk=64)


# ----------------------------------------------------- the engine's graph

# the full width of internlm2-20b (the serving cells' model) at 4 of its
# 48 layers; 80 steps of one HIGH and four LOW agent sessions, a pool of
# 16 eight-token pages and LOW highs of 4 pages: throttles, three freezes,
# a thaw and a finished session
GRAPH_LAYERS = 4
GRAPH_STEPS = 80


def _agent_sessions() -> list:
    from repro_torch.core import domains as D
    from repro_torch.serving import session as S
    out = [S.Session(sid="hi", tenant="fg", priority=D.HIGH,
                     prompt=list(range(2, 18)),
                     phases=[S.Phase(4, 40, "test"), S.Phase(6, 0)])]
    for i in range(4):
        out.append(S.Session(
            sid=f"lo{i}", tenant="bg", priority=D.LOW,
            prompt=list(range(3 + i, 19 + 5 * i)),
            phases=[S.Phase(4, 48 + 16 * i, "test"), S.Phase(4, 0)]))
    return out


def _serve_recorded(eng) -> tuple:
    """``GRAPH_STEPS`` steps of the agent sessions: each step's tokens
    and grants, and the launches the wrappers counted."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    seen = []
    real = eng._device_step

    def step(*args, **kw):
        out = real(*args, **kw)
        seen.append((out[0].cpu().clone(), out[2].cpu().clone()))
        return out
    eng._device_step = step
    for s in _agent_sessions():
        eng.submit(s)
    reset_launch_counts()
    eng.run(GRAPH_STEPS)
    torch.cuda.synchronize()
    return seen, launch_counts()


def test_graphed_engine_step_equals_the_eager_step(dev):
    """A card engine replays its step's device part as one CUDA graph from
    the second step on; the same engine with the eager device part called
    directly gives the same tokens and grants each step, the same control
    table, report and sessions' tokens, and the wrappers count the same
    launches: one decode a layer a step."""
    import dataclasses

    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(get_config("internlm2-20b"),
                              n_layers=GRAPH_LAYERS)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    ecfg = EngineConfig(max_slots=4, s_max=256, pool_pages=16, page_tokens=8,
                        session_high={f"lo{i}": 4 for i in range(4)})
    runs = []
    for graphed in (True, False):
        eng = Engine(cfg, params, ecfg=ecfg, seed=0, device=dev)
        if not graphed:
            eng._graph = None
        runs.append((eng,) + _serve_recorded(eng))
    (geng, got, gcounts), (eeng, want, ecounts) = runs
    for i, ((a, b), (c, d)) in enumerate(zip(got, want)):
        assert torch.equal(a, c) and torch.equal(b, d), i
    report = geng.report()
    assert report == eeng.report()
    assert report["freezes"] >= 1 and report["thaws"] >= 1
    assert report["completed"] >= 1 and report["throttle_triggers"] >= 1
    assert [s.out_tokens for s in geng.sessions.values()] == \
        [s.out_tokens for s in eeng.sessions.values()]
    gst, est = geng._view.state, eeng._view.state
    assert gst.keys() == est.keys()
    for k in gst:
        assert torch.equal(gst[k], est[k]), k
    assert gcounts == ecounts
    assert gcounts["decode_attention"] == GRAPH_LAYERS * GRAPH_STEPS
    assert gcounts["fused_charge_batch"] == GRAPH_STEPS
    st = tracing.steps()
    mine = st["engine"] == geng.trace_id
    assert st["graphed"][mine].tolist() == [0] + [1] * (GRAPH_STEPS - 1)
    assert not st["graphed"][st["engine"] == eeng.trace_id].any()
