"""DeepSeek-V2's published block on the port's serving path against the
plain reference (``reference/deepseek.py``) at a tiny size on the CPU:
the forward and the decode through the latent cache in float32, YaRN's
table against its closed form, group-limited routing on a hand-built
case, the experts' shares adding up to the whole layer, a slot's decode
not depending on the other slots (dropless), the float8 control failing
the limit the bfloat16 program keeps, the frozen MLA cost against the
program's, and a serving run of the tiny model through the harness."""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.harness import (bench, checks, costs,  # noqa: E402
                               costs_mla, weights)
from portbench.reference import deepseek  # noqa: E402
from portbench.tests import tiny  # noqa: E402

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 64,
        "type": "yarn"}
# d 64; a dense first layer, then 2 MoE layers of 8 groups of 2 experts
# (top 4 among the 3 best groups, gates the probabilities times 16) and
# 2 shared experts; YaRN over the 8 rope dims.  The capacity factor lets
# the forward's capacity dispatch keep every assignment (cap > T), as
# the reference does.
TINY = dict(
    name="tiny-deepseek",
    source="https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json",
    family="moe", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=500,
    moe={"n_experts": 16, "top_k": 4, "d_ff_expert": 32, "n_shared": 2,
         "period": 1, "n_routed": 16, "first_expert": 0, "n_group": 8,
         "topk_group": 3, "routed_scale": 16.0, "norm_topk": False,
         "first_dense": 1},
    mla={"kv_lora_rank": 16, "q_lora_rank": 32, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "rope_scaling": YARN},
    rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False,
    dtype="float32", group_size=1, attn_period=1, attn_offset=0,
    perf={"moe_impl": "a2a", "capacity_factor": 4.0, "scan_chunk": 256},
    reference="deepseek",
    # output projections as wide as the rest, so that at this width the
    # layers, and what the latent cache holds, move the logits
    init={"normal": 0.02, "small": 0.02, "leaves": {}})
# between the bfloat16 program's decode and the float8 control at this
# size, seeds 5-10: 0.0053-0.0270 against 0.0567-0.0737 (the program's
# spread is the near ties of the top-4 routing that bfloat16 flips)
TINY_REL_LIMIT = 0.04
CPU = torch.device("cpu")


def _model(cfg: dict, seed: int):
    prog = bench.program()
    mcfg = bench.model_config(prog, cfg)
    params = weights.make_params(prog["model"].param_leaves(mcfg),
                                 cfg["init"], cfg["dtype"], seed, CPU)
    return prog, mcfg, params


def _tokens(seed: int, shape) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, TINY["vocab"], shape))


def _decode(prog, mcfg, params, seqs: torch.Tensor) -> torch.Tensor:
    """Each row of ``seqs`` fed one token a step from an empty cache, as
    the engine feeds a prompt: the logits at every position."""
    M = prog["model"]
    B, T = seqs.shape
    state = M.decode_state(mcfg, B, 64, device=CPU)
    out = []
    with torch.inference_mode():
        for t in range(T):
            lg, _ = M.decode_step(mcfg, params, state, seqs[:, t],
                                  torch.full((B,), t, dtype=torch.int32))
            out.append(lg)
    return torch.stack(out, 1)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_forward_matches_the_reference_in_float32(seed):
    prog, mcfg, params = _model(TINY, seed)
    tok = _tokens(seed, (1, 48))
    perf = prog["perf"].PerfConfig(**TINY["perf"])
    with torch.inference_mode():
        got, _ = prog["model"].forward(mcfg, params, {"tokens": tok},
                                       perf=perf)
    want = deepseek.logits_at(TINY, params, [tok[0]], [torch.arange(48)])
    assert checks.rel_err([got[0]], want) < 2e-5


def test_decode_through_the_latent_cache_matches_the_full_forward():
    """Prefill and decode alike go one token a step through the latent
    cache (absorbed MLA); the reference runs each sequence whole."""
    prog, mcfg, params = _model(TINY, 4)
    seqs = _tokens(4, (3, 40))
    got = _decode(prog, mcfg, params, seqs)
    want = deepseek.logits_at(TINY, params, list(seqs),
                              [torch.arange(40)] * 3)
    for g, w in zip(got, want):
        assert checks.rel_err([g], [w]) < 2e-5


def _closed_form_freqs(dim, theta, factor, orig, fast, slow):
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies, in
    float64 from its formulas."""
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            theta))
    low = max(math.floor(corr(fast)), 0)
    high = min(math.ceil(corr(slow)), dim - 1)
    extra = np.array([1 / theta ** (2 * i / dim) for i in range(dim // 2)])
    inter = extra / factor
    ramp = np.clip((np.arange(dim // 2) - low) / (high - low), 0, 1)
    return (low, high), inter * ramp + extra * (1 - ramp)


def test_yarn_table_is_the_closed_form():
    from repro_torch.configs.base import YarnConfig
    from repro_torch.models.attention import mla_scale
    from repro_torch.models.layers import _yarn_bounds, rope_table
    pub = json.loads((tiny.ROOT / "portbench" / "configs"
                      / "deepseek-v2-236b.json").read_text())
    y = pub["rope_scaling"]
    yarn = YarnConfig(**y)
    bounds, want = _closed_form_freqs(64, 1e4, 40, 4096, 32, 1)
    assert bounds == (10, 23) == _yarn_bounds(yarn, 64, 1e4)
    cos, sin = rope_table(1, 64, 1e4, positions=torch.ones(1), yarn=yarn)
    np.testing.assert_allclose(torch.atan2(sin, cos)[0].numpy(), want,
                               rtol=2e-6)
    # mscale equals mscale_all_dim: cos and sin unscaled
    np.testing.assert_allclose((cos ** 2 + sin ** 2).numpy(), 1, rtol=1e-6)
    mcfg = bench.model_config(bench.program(), pub)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla_scale(mcfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    # another mscale scales cos and sin by the ratio
    other = dataclasses.replace(yarn, mscale=1.0)
    cos, sin = rope_table(1, 64, 1e4, positions=torch.ones(1), yarn=other)
    ratio = (0.1 * math.log(40) + 1) / m
    np.testing.assert_allclose((cos ** 2 + sin ** 2).numpy(), ratio ** 2,
                               rtol=1e-6)


def test_group_limited_routing_on_a_hand_built_case():
    """Groups of 2: the best experts of groups 0-3 are 5.0, 4.9, 4.8 and
    4.7, the others 0.  Plain top 4 takes experts 0, 2, 4 and 6; the
    3 best groups are 0-2, so expert 6 is out and the fourth is the
    first of the rest within them, expert 1.  The gates are the softmax
    probabilities over all 16 times 16, not renormalised."""
    from repro_torch.models import moe as moe_mod
    prog, mcfg, _ = _model(TINY, 0)
    logits = torch.zeros(16)
    logits[[0, 2, 4, 6]] = torch.tensor([5.0, 4.9, 4.8, 4.7])
    router = torch.zeros(64, 16)
    router[0] = logits
    x = torch.zeros(1, 64)
    x[0, 0] = 1.0
    probs, ids, gates = moe_mod._router(mcfg, {"router": router}, x)
    assert ids.tolist() == [[0, 2, 4, 1]]
    want = torch.softmax(logits, -1)[[0, 2, 4, 1]] * 16
    torch.testing.assert_close(gates[0], want)
    ref_ids, ref_w = deepseek.route(TINY, router, x)
    assert ref_ids.tolist() == ids.tolist()
    torch.testing.assert_close(ref_w, gates)
    plain = bench.model_config(prog, dict(TINY, moe=dict(
        TINY["moe"], n_group=1, topk_group=1)))
    assert moe_mod._router(plain, {"router": router}, x)[1].tolist() == \
        [[0, 2, 4, 6]]


def test_the_eight_shares_add_up_to_the_whole_layer():
    """Each card of EP8 holds one group's 2 experts and computes their
    part; the 8 parts with the shared experts counted once are the uncut
    reference layer."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.perf import DEFAULT_PERF
    prog, mcfg, params = _model(TINY, 9)
    p = {k: v[0] for k, v in params["groups"][0]["ffn"].items()
         if k != "shared"}
    p["shared"] = {k: v[0] for k, v in
                   params["groups"][0]["ffn"]["shared"].items()}
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(9))
    dense = dataclasses.replace(DEFAULT_PERF, moe_impl="dense")
    with torch.inference_mode():
        shared = moe_mod._shared(p, x)
        total = shared.clone()
        for g in range(8):
            share = bench.model_config(prog, dict(TINY, moe=dict(
                TINY["moe"], n_experts=2, first_expert=2 * g)))
            sp = dict(p, wg=p["wg"][2 * g:2 * g + 2],
                      wu=p["wu"][2 * g:2 * g + 2],
                      wd=p["wd"][2 * g:2 * g + 2])
            y, _ = moe_mod.moe_forward(share, sp, x[None], perf=dense)
            total += y[0] - shared
        W = deepseek.Weights("float32")
        want = deepseek.moe(TINY, deepseek.products(p, W), x, W)
    assert checks.rel_err([total], [want]) < 1e-6


def test_a_slots_decode_does_not_depend_on_the_other_slots():
    """Dropless decode: slot 0's logits are bit-identical whether the 15
    other slots of the step are idle or decode sessions of their own
    (under a capacity over the step's slots their routing would drop
    some of slot 0's assignments)."""
    prog, mcfg, params = _model(TINY, 11)
    seq = _tokens(11, (1, 24))
    idle = torch.cat([seq, torch.zeros(15, 24, dtype=seq.dtype)])
    busy = torch.cat([seq, _tokens(12, (15, 24))])
    a = _decode(prog, mcfg, params, idle)
    b = _decode(prog, mcfg, params, busy)
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])


def test_the_float8_control_fails_the_limit():
    """The program in the configuration's bfloat16, decoding through its
    latent cache, keeps within the limit of the float32 reference; the
    reference with float8 weight products (the control) does not."""
    for seed in (5, 6, 7):
        cfg = dict(TINY, dtype="bfloat16")
        prog, mcfg, params = _model(cfg, seed)
        seqs = _tokens(seed, (2, 32))
        got = _decode(prog, mcfg, params, seqs)
        pos = [torch.arange(32)] * 2
        want = deepseek.logits_at(cfg, params, list(seqs), pos)
        low = deepseek.logits_at(cfg, params, list(seqs), pos,
                                 precision="float8")
        assert checks.rel_err(list(got), want) < TINY_REL_LIMIT
        assert checks.rel_err(low, want) > TINY_REL_LIMIT


@pytest.mark.parametrize("name", ["published", "tiny"])
def test_mla_cost_matches_the_program(name):
    from repro_torch.analysis.roofline import mla_decode_flops
    cfg = TINY if name == "tiny" else json.loads(
        (tiny.ROOT / "portbench" / "configs" / "deepseek-v2-236b.json")
        .read_text())
    mcfg = bench.model_config(bench.program(), cfg)
    for context, assigned in ((1, 0.0), (300, 4.25), (4096, 96.0)):
        assert costs_mla.mla_decode_flops(cfg, context, assigned) == \
            mla_decode_flops(mcfg, context, assigned)


def test_a_tiny_serving_run_through_the_harness(tmp_path, monkeypatch):
    """The tiny model served by the engine (each prompt fed through the
    latent cache, then decoded) through the harness: correct against the
    reference, the served tokens' gap ~0 in float32, both new metrics
    read in a traced run and the padded share what the counts give."""
    from portbench.tests.test_portbench_tracing import _window_of_steps
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    (pb / "configs" / "tiny-deepseek.json").write_text(json.dumps(TINY))
    (pb / "traffic" / "tiny_wide.json").write_text(json.dumps(
        tiny.tiny_serve_mix()))
    (pb / "checks" / "tiny-deepseek.wide.json").write_text(json.dumps(
        tiny.SERVE_CHECKS))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-deepseek", "source": TINY["source"],
                         "file": "portbench/configs/tiny-deepseek.json",
                         "reduced": [], "why": "a CPU test"})
    b["workloads"].append({"name": "tiny-deepseek.wide",
                           "config": "tiny-deepseek", "traffic": "tiny_wide",
                           "chips": 1, "why": "a CPU test"})
    for m in b["end_to_end"]:
        if m["name"] == "served_tokens_per_s":
            m["workloads"].append("tiny-deepseek.wide")
    # the MLA cell's metrics, as a benchmark that holds the cell lists them
    for name, unit, better, source in (
            ("step.mfu.serve_mla", "%", "higher", "host_clock"),
            ("moe.padded_row_share", "%", "lower", "program_counter")):
        b["per_layer"].append({"name": name, "unit": unit, "better": better,
                               "source": source, "layer": "a CPU test",
                               "moves": "served_tokens_per_s",
                               "workloads": ["tiny-deepseek.wide"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    ctx = bench.load_cell(root, "tiny-deepseek.wide")
    _window_of_steps(monkeypatch, 24)
    out = bench.execute(ctx, 2 ** 31 + 41, 0.5, 1, CPU)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert out["numbers"]["served_gap"] < 1e-4
    got = res["metrics"]
    assert 0 < got["step.mfu.serve_mla"]["value"] < 100
    # 4 slots, top 4 of 16 held experts over 2 MoE layers: a step
    # computes 128 rows, and each slot it grants gets 8 assignments
    from repro_torch import tracing
    st = tracing.steps()
    mine = st["engine"] == st["engine"][-1]      # this run's engine
    assert (st["moe_rows"][mine] == 128).all()
    assert (st["moe_assigned"][mine] % 8 == 0).all()
    assert (st["moe_assigned"][mine] <= 32).all()
    assert 75.0 <= got["moe.padded_row_share"]["value"] < 100.0


def test_the_counts_take_only_the_granted_slots():
    """``moe_assigned`` counts the assignments of the slots the gate
    granted, ``moe_rows`` every row the dense dispatch computed."""
    prog, mcfg, params = _model(TINY, 13)
    M = prog["model"]
    state = M.decode_state(mcfg, 4, 64, device=CPU)
    counts = torch.zeros(2, dtype=torch.int64)
    keep = torch.tensor([True, False, True, False])
    with torch.inference_mode():
        M.decode_step(mcfg, params, state, _tokens(13, (4,)),
                      torch.zeros(4, dtype=torch.int32), keep=keep,
                      counts=counts)
    # 2 MoE layers: 2 granted slots x top 4, and 16 experts x 4 slots
    assert counts.tolist() == [2 * 2 * 4, 2 * 16 * 4]


def _serve_run(t0: float, t1: float, cfg: dict) -> dict:
    return {"kind": "serve", "t0": t0, "t1": t1, "window_s": t1 - t0,
            "cfg": cfg, "mix": tiny.tiny_serve_mix(),
            "steps": [{"granted": 4, "asked": 4, "granted_keys": 40}] * 2}


@pytest.mark.parametrize("metric", ["moe.padded_row_share",
                                    "step.mfu.serve_mla"])
def test_the_readers_read_nothing_from_a_clock_without_the_columns(
        metric, monkeypatch):
    """A program whose step clock has no MoE columns (the parent of
    this benchmark's DeepSeek cell) gives no reading, and no error."""
    import time

    from repro_torch import tracing
    read = bench.reader(tiny.ROOT, metric)
    tracing.reset()
    t0 = time.perf_counter()
    for i in range(2):
        now = time.perf_counter_ns()
        tracing.record_step(-1, i, [now] * (len(tracing.PHASES) + 1), 1,
                            (16, 64))
    run = _serve_run(t0, time.perf_counter(), TINY)
    assert read(run) is not None
    real = tracing.steps
    monkeypatch.setattr(tracing, "steps", lambda: {
        k: v for k, v in real().items()
        if k not in ("moe_assigned", "moe_rows")})
    assert read(run) is None
    monkeypatch.setattr(tracing, "steps", real)
    assert read(_serve_run(t0 - 10, t0 - 5, TINY)) is None


def test_the_latent_decode_cost_matches_the_program():
    from repro_torch.kernels import mla_decode as MD
    for B, lengths in ((1, [1]), (3, [7, 4096, 300])):
        got = costs_mla.mla_decode_cost(B, 128, 512, 64, lengths)
        want = MD.cost(B, 128, 512, 64, lengths)
        assert (got["ops"], got["bytes"]) == (want["ops"], want["bytes"])


def _traced_run(kernels: dict, launches: dict) -> dict:
    cfg = json.loads((tiny.ROOT / "portbench" / "configs"
                      / "deepseek-v2-236b.json").read_text())
    outs = [{"lengths": [99, 0, 4095]}, {"lengths": [100, 0, 4095]}]
    return {"kind": "serve", "cfg": cfg,
            "trace": {"kernels": kernels, "launches": launches,
                      "outs": outs}}


@pytest.mark.parametrize("kernels, launches, want", [
    # 30 MLA layers a step over 2 traced steps, 1 ms of device time
    ({"(anonymous namespace)::mla_decode_kernel(Args)": (1e-3, 60)},
     {"mla_decode": 60}, "bound"),
    # a program without the kernel (the parent): nothing
    ({"nvjet_tst_128x32": (1e-3, 60)}, {"decode_attention": 0}, None),
    # the profiler saw other launches than the program counted: nothing
    ({"(anonymous namespace)::mla_decode_kernel(Args)": (1e-3, 59)},
     {"mla_decode": 60}, None),
])
def test_the_latent_decode_roofline_reader(kernels, launches, want):
    read = bench.reader(tiny.ROOT, "mla_decode.roofline")
    run = _traced_run(kernels, launches)
    got = read(run)
    if want is None:
        assert got is None
        return
    cfg = run["cfg"]
    bound = sum(30 * costs.bound_s(costs_mla.mla_decode_cost(
        3, cfg["n_heads"], 512, 64, [x + 1 for x in o["lengths"]]))
        for o in run["trace"]["outs"])
    assert got == pytest.approx(100.0 * bound / 1e-3)
