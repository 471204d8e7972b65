"""The absorbed MLA decode (``kernels/mla_decode.py``): the plain version
against a softmax written out in float64, the wrapper's CPU and meta
branches and what it refuses, and, marked ``cuda``, the kernel against
the plain version on the card at DeepSeek-V2's latent widths, from a
layer of a stacked cache and inside a CUDA graph.  Without a card the
``cuda`` tests skip; on the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_mla_decode.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fake  # noqa: E402
from repro_torch.kernels import mla_decode as MD  # noqa: E402


def _inputs(B, H, S, L, R, lengths, dtype, device="cpu", seed=0,
            layers=1):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(
            device)

    # a stacked cache (layers, B, S, *) as the engine keeps it; the last
    # layer's view is what the model hands over
    ckv = rnd(layers, B, S, L)[-1]
    krope = rnd(layers, B, S, R)[-1]
    q_lat = rnd(B, H, L, scale=L ** -0.5)
    q_rope = rnd(B, H, R, scale=L ** -0.5)
    live = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q_lat, q_rope, ckv, krope, live


def _softmax64(q_lat, q_rope, ckv, krope, live):
    """The same attention, written out in float64 over each slot's live
    rows."""
    out = []
    for b, n in enumerate(live.tolist()):
        c = ckv[b, :n].double()
        s = q_lat[b].double() @ c.T + q_rope[b].double() @ krope[b, :n].double().T
        out.append(torch.softmax(s, -1) @ c)
    return torch.stack(out)


@pytest.mark.parametrize("S, lengths", [(64, [1, 17, 64]),
                                        (4096, [1, 2047, 2049, 4096])])
def test_the_plain_version_is_a_masked_softmax(S, lengths):
    """In float32 the blocked online softmax is the whole-row softmax
    over the live rows (the blocks of 2048 rows meet at 2048)."""
    args = _inputs(len(lengths), 4, S, 16, 8, lengths, torch.float32)
    got = MD.mla_decode_plain(*args)
    want = _softmax64(*args)
    assert (got.double() - want).abs().max().item() < 1e-5


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    args = _inputs(3, 32, 128, 512, 64, [1, 50, 128], torch.bfloat16)
    before = MD.mla_decode.launches
    assert torch.equal(MD.mla_decode(*args), MD.mla_decode_plain(*args))
    assert MD.mla_decode.launches == before


def test_meta_tensors_record_the_cost_and_launch_nothing():
    """Tensors that hold no data: the output allocated, the cost over
    the whole cache recorded, nothing launched."""
    args = [t.to("meta") for t in _inputs(2, 128, 256, 512, 64, [3, 9],
                                          torch.bfloat16)]
    seen = []
    token = fake.set_recorder(lambda name, cost: seen.append((name, cost)))
    try:
        before = MD.mla_decode.launches
        out = MD.mla_decode(*args)
    finally:
        fake.reset_recorder(token)
    assert out.shape == (2, 128, 512) and out.is_meta
    assert MD.mla_decode.launches == before
    assert [name for name, _ in seen] == ["mla_decode"]
    assert seen[0][1]["ops"] == 2 * (2 * 256) * 128 * (2 * 512 + 64)


@pytest.mark.parametrize("what, B, H, L, R, dtype", [
    ("latent width", 2, 128, 256, 64, torch.bfloat16),
    ("rope width", 2, 128, 512, 32, torch.bfloat16),
    ("heads", 2, 48, 512, 64, torch.bfloat16),
    ("dtype", 2, 128, 512, 64, torch.float32),
])
def test_the_kernel_refuses_what_it_does_not_take(what, B, H, L, R, dtype):
    args = [t.to("meta") for t in _inputs(B, H, 64, L, R, [1] * B, dtype)]
    with pytest.raises(ValueError):
        MD.mla_decode(*args)


# ------------------------------------------------------------ on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _slot_rel(got, want) -> float:
    """The largest over slots of |got - want| / |want| (Frobenius)."""
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    return (d / want.float().flatten(1).norm(dim=1)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B, H, S, lengths", [
    (4, 128, 4096, [1, 63, 64, 65]),
    (3, 32, 4096, [4096, 2049, 700]),
    (128, 128, 4096, "random"),
])
def test_the_kernel_matches_the_plain_version(dev, B, H, S, lengths):
    """bf16 on the card, from the last layer of a stacked cache: each
    slot within 1e-2 of the plain version (Frobenius, relative), which
    rounds P in other places (its blocks hold 2048 rows, the kernel's
    64) and sums in another order."""
    if lengths == "random":
        g = torch.Generator().manual_seed(5)
        lengths = torch.randint(1, S + 1, (B,), generator=g).tolist()
    args = _inputs(B, H, S, 512, 64, lengths, torch.bfloat16, dev, seed=B,
                   layers=2)
    before = MD.mla_decode.launches
    got = MD.mla_decode(*args)
    torch.cuda.synchronize()
    assert MD.mla_decode.launches == before + 1
    want = MD.mla_decode_plain(*args)
    assert _slot_rel(got, want) < 1e-2
    if B <= 4:
        exact = _softmax64(*[t.cpu() for t in args])
        assert _slot_rel(got.cpu(), exact) < 1e-2


@pytest.mark.cuda
def test_the_kernel_replays_in_a_cuda_graph(dev):
    """Captured once and replayed with new lengths: the replay follows
    the lengths it reads on the device."""
    q_lat, q_rope, ckv, krope, live = _inputs(
        8, 128, 1024, 512, 64, [5] * 8, torch.bfloat16, dev, seed=3)
    MD.mla_decode(q_lat, q_rope, ckv, krope, live)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = MD.mla_decode(q_lat, q_rope, ckv, krope, live)
    live.copy_(torch.tensor([1, 9, 100, 1024, 512, 64, 65, 300],
                            dtype=torch.int32, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    want = MD.mla_decode_plain(q_lat, q_rope, ckv, krope, live)
    assert _slot_rel(out, want) < 1e-2


def test_the_model_step_hands_the_kernel_what_it_takes():
    """A bf16 decode step of the published DeepSeek-V2 block (the dense
    first layer and one MoE layer) on meta tensors: each MLA layer gives
    the kernel's wrapper q in the layout it takes, one call a layer."""
    import dataclasses
    import json
    from pathlib import Path

    from portbench.harness import bench
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M

    path = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
            / "deepseek-v2-236b.json")
    cfg = bench.model_config(bench.program(), json.loads(path.read_text()))
    cfg = dataclasses.replace(cfg, n_layers=2)
    params = dryrun.meta_params(cfg)
    state = M.decode_state(cfg, 4, 256, device="meta")
    seen = []
    token = fake.set_recorder(lambda name, cost: seen.append(name))
    try:
        M.decode_step(cfg, params, state,
                      torch.zeros(4, dtype=torch.int64, device="meta"),
                      torch.zeros(4, dtype=torch.int32, device="meta"))
    finally:
        fake.reset_recorder(token)
    assert seen == ["mla_decode", "mla_decode"]
