"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, MoE every other layer; early fusion.  48L d_model=5120 40H (GQA
kv=8) d_ff=8192 vocab=202048 [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified].

Port of ``repro/configs/llama4_maverick_400b_a17b.py`` (same values)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1, period=2),
    rope_theta=5e5,
    group_size=2,            # dense/MoE alternation scans as 2-layer groups
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
