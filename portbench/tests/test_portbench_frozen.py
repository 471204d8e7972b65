"""The benchmark's frozen copies equal the program's functions today: the
trace generator and the session mapping, the kernels' costs, the
parameter count and model FLOPs, the card's peaks.  A difference means
one side changed; the benchmark's copy is the yardstick and stays."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.harness import costs, tracegen  # noqa: E402
from portbench.tests.tiny import ROOT  # noqa: E402


@pytest.mark.parametrize("model", ["haiku", "glm", "qwen"])
@pytest.mark.parametrize("seed,scale", [(0, None), (2026000, 0.6),
                                        (3000000001, 1.3)])
def test_generate_task_matches_the_program(model, seed, scale):
    from repro_torch.traces.generator import generate_task
    want = generate_task(f"t{seed}", model, seed, scale=scale)
    got = tracegen.generate_task(f"t{seed}", model, seed, scale=scale)
    assert [dataclasses.astuple(c) for c in got.tool_calls] == \
        [dataclasses.astuple(c) for c in want.tool_calls]
    np.testing.assert_array_equal(got.mem_mb, want.mem_mb)
    np.testing.assert_array_equal(got.cpu_pct, want.cpu_pct)
    assert (got.duration_s, got.init_s, got.baseline_mb) == \
        (want.duration_s, want.init_s, want.baseline_mb)


@pytest.mark.parametrize("tpm,gen,phases", [(0.2, 16, 6), (64.0, 16, 6),
                                            (4.0, 24, 12)])
def test_session_phases_match_session_from_trace(tpm, gen, phases):
    from repro_torch.serving.session import session_from_trace
    from repro_torch.traces.generator import generate_task
    for k in range(6):
        trace = generate_task(f"a{k}", ("haiku", "glm")[k % 2], 77 + k,
                              scale=0.6)
        s = session_from_trace("s", "t", trace, tokens_per_mb=tpm,
                               gen_per_call=gen, max_phases=phases)
        ours = tracegen.session_phases(
            tracegen.generate_task(f"a{k}", ("haiku", "glm")[k % 2], 77 + k,
                                   scale=0.6),
            tokens_per_mb=tpm, gen_per_call=gen, max_phases=phases)
        assert ours == [(p.gen_tokens, p.append_tokens, p.category)
                        for p in s.phases]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B,H,hkv,d,lengths", [
    (32, 48, 8, 128, [1, 17, 300, 2048] * 8),
    (8, 32, 8, 128, [5] * 8), (4, 40, 8, 160, [1000, 1, 2, 3])])
def test_decode_cost_matches(B, H, hkv, d, lengths):
    from repro_torch.kernels.decode_attention import cost
    q, k = _meta(B, H, d), _meta(B, 2048, hkv, d)
    assert costs.decode_cost(B, H, hkv, d, d, lengths) == \
        {**cost(q, k, k, lengths), "dtype": "bfloat16"}


@pytest.mark.parametrize("B,S,H,hkv,d,causal", [
    (1, 32768, 32, 8, 128, True), (2, 4096, 48, 8, 128, True),
    (1, 4096, 16, 16, 80, False)])
def test_flash_cost_matches(B, S, H, hkv, d, causal):
    from repro_torch.kernels.flash_attention import cost
    q, k = _meta(B, S, H, d), _meta(B, S, hkv, d)
    assert costs.flash_cost(B, S, H, d, S, hkv, d, causal=causal) == \
        {**cost(q, k, k, causal=causal), "dtype": "bfloat16"}


@pytest.mark.parametrize("b,s,nh,dh,N,chunk", [
    (1, 32768, 8, 1024, 16, 256), (2, 512, 2, 64, 8, 128),
    (1, 100, 4, 36, 4, 256)])
def test_ssd_cost_matches(b, s, nh, dh, N, chunk):
    from repro_torch.kernels.mamba_scan import cost
    x, dt = _meta(b, s, nh, dh), _meta(b, s, nh, dtype=torch.float32)
    A, B = _meta(nh, dtype=torch.float32), _meta(b, s, N)
    assert costs.ssd_cost(b, s, nh, dh, N, chunk=chunk) == \
        {**cost(x, dt, A, B, B, A, chunk=min(chunk, s)), "dtype": "bfloat16"}


@pytest.mark.parametrize("n,P,m,walks", [
    (136, 4, 32, [(20, 100)]), (4104, 10, 8, [(30, 32)] * 8)])
def test_charge_cost_matches(n, P, m, walks):
    from repro_torch.kernels.enforcement import charge_cost
    lead = (len(walks),) if len(walks) > 1 else ()
    state = {"prog": _meta(*lead, n, P, dtype=torch.float32)}
    dom = _meta(*lead, m, dtype=torch.int32)
    want = charge_cost(state, dom, walks)
    assert costs.charge_cost(n, P, m, walks) == {**want, "dtype": "float32"}


@pytest.mark.parametrize("seed", range(4))
def test_charge_walks_match(seed):
    from repro_torch.kernels.enforcement_bench import walks
    rng = np.random.default_rng(seed)
    n = 40
    parent = np.full(n, -1, np.int32)
    for i in range(1, n):
        parent[i] = rng.integers(0, i)
    dom = rng.integers(-1, n, 32).astype(np.int32)
    want = walks({"parent": torch.from_numpy(parent)}, torch.from_numpy(dom))
    assert [costs.charge_walks(parent, dom)] == want


def _config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: v for k, v in d.items() if v is not None}


@pytest.mark.parametrize("arch,layers", [
    ("internlm2-20b", None), ("jamba-v0.1-52b", None),
    ("jamba-v0.1-52b", 8), ("llama3.2-3b", None), ("minicpm-2b", None),
    ("phi3-medium-14b", None)])
def test_param_count_and_model_flops_match(arch, layers):
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    d = _config_dict(cfg)
    for active in (False, True):
        assert costs.param_count(d, active) == cfg.param_count(active)
    for shape in ("prefill_32k", "decode_32k"):
        s = SHAPES[shape]
        assert costs.model_flops(d, s.kind, s.global_batch, s.seq_len) == \
            model_flops(cfg, s)


@pytest.mark.parametrize("name", ["internlm2-20b", "jamba-v0.1-52b"])
def test_config_files_match_the_programs_configs(name):
    from repro_torch.configs import get_config
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    prog = _config_dict(get_config(name))
    prog["head_dim"] = get_config(name).head_dim_
    # what the file changes from the program's config, and why
    changed = {"n_layers", "norm_eps", "source"}
    for k, v in prog.items():
        if k in cfg and k not in changed:
            if isinstance(v, dict):
                assert cfg[k] == {j: v[j] for j in cfg[k]}, k
            else:
                assert cfg[k] == v, k
    assert costs.layer_kinds(cfg) == get_config(name).layer_kinds()
    assert costs.ffn_kinds(cfg) == get_config(name).ffn_kinds()


def test_peaks_match():
    from repro_torch.launch.mesh import HW
    assert costs.HW == HW
