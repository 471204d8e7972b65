"""A benchmark root at a size the CPU runs in seconds: the repository's
``BENCHMARK.json`` and ``portbench/`` copied, with a tiny float32 copy
of each configuration and a short copy of each traffic mix added as
files, and three cells naming them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_CONFIGS = {
    "tiny-dense": dict(
        name="tiny-dense", source="https://huggingface.co/internlm/internlm2-20b",
        family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=500, rope_theta=1e6, norm_eps=1e-5,
        tie_embeddings=False, dtype="float32", group_size=1, attn_period=1,
        attn_offset=0,
        perf={"moe_impl": "a2a", "capacity_factor": 1.25, "scan_chunk": 256},
        reference="decoder",
        # output projections as wide as the rest, so that at this width
        # the layers, and what the caches hold, move the logits
        init={"normal": 0.02, "small": 0.02, "leaves": {}}),
    "tiny-hybrid": dict(
        name="tiny-hybrid", source="https://huggingface.co/ai21labs/Jamba-v0.1",
        family="hybrid", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512,
        moe={"n_experts": 4, "top_k": 2, "d_ff_expert": 64, "n_shared": 0,
             "period": 2},
        ssm={"d_state": 8, "d_conv": 4, "expand": 2, "chunk": 16,
             "n_ssm_heads": 2},
        attn_period=8, attn_offset=4, rope_theta=0.0, norm_eps=1e-6,
        tie_embeddings=False, dtype="float32", group_size=8,
        perf={"moe_impl": "a2a", "capacity_factor": 1.25, "scan_chunk": 16},
        reference="jamba",
        # the Mamba leaves wider than at full width, so that at d 64 the
        # scan's state still moves each Mamba layer's output
        init={"normal": 0.02, "small": 0.002, "leaves": {
            "in_proj": {"std": 0.1}, "conv_w": {"std": 0.3},
            "x_to_bc": {"std": 0.1}, "a_log": {"std": 0.5},
            "dt_bias": {"std": 1.0}, "d_skip": {"std": 0.5, "mean": 1.0}}}),
}


def tiny_serve_mix(calm: bool = False) -> dict:
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "agent_bursts.json").read_text())
    mix["engine"].update(max_slots=4, s_max=256, pool_pages=12)
    if calm:
        mix["engine"].update(pool_pages=64, use_intent=False)
    mix["tenants"] = [{"name": "fg", "priority": "HIGH", "clients": 1},
                      {"name": "bg", "priority": "LOW", "clients": 4}]
    mix["sessions"].update(rounds=2, prompt_tokens=[4, 8],
                           tokens_per_mb=4.0, gen_per_call=6)
    # enough steps before the window that tokens have been served
    mix["warm_steps"] = 16
    mix["trace_calls"] = 2
    return mix


def tiny_prefill_mix() -> dict:
    mix = json.loads((ROOT / "portbench" / "traffic"
                      / "repo_prefill.json").read_text())
    mix.update(seq_len=64, distinct_prompts=2, warm=1, trace_calls=1)
    return mix


CELLS = {
    "tiny-dense.bursts": ("tiny-dense", "tiny_bursts", tiny_serve_mix()),
    "tiny-dense.calm": ("tiny-dense", "tiny_calm", tiny_serve_mix(True)),
    "tiny-hybrid.prefill": ("tiny-hybrid", "tiny_prefill", tiny_prefill_mix()),
}

SERVE_CHECKS = {"served_tokens": 40, "max_sessions": 3,
                "limits": {"served_gap": 1e-3, "charge_mismatch_steps": 0,
                           "table_mismatch_domains": 0,
                           "pool_overshoot_pages": 0}}
PREFILL_CHECKS = {"prefills": 1, "positions": 16, "position_tol": 1e-4,
                  "limits": {"off_positions_share": 10.0}}


def make_root(dst: Path) -> Path:
    """A copy of the benchmark with the tiny cells added as files only."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    pb = dst / "portbench"
    for name, cfg in TINY_CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "a CPU test"})
    for cell, (cfg, mix_name, mix) in CELLS.items():
        (pb / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
        checks = SERVE_CHECKS if mix["kind"] == "serve" else PREFILL_CHECKS
        (pb / "checks" / f"{cell}.json").write_text(json.dumps(checks))
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix_name, "chips": 1,
                                   "why": "a CPU test"})
        metric = ("served_tokens_per_s" if mix["kind"] == "serve"
                  else "prefill_tokens_per_s")
        for m in bench["end_to_end"]:
            if m["name"] == metric:
                m["workloads"].append(cell)
        for m in bench["per_layer"]:
            if m["moves"] == metric and "workloads" in m:
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
