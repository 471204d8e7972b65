"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887; hf]
Attention on one layer per 8-layer group (1:7 attn:mamba); MoE FFN every
other layer (period 2), as in the Jamba paper.

Port of ``repro/configs/jamba_v0_1_52b.py`` (same values)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, n_shared=0,
                  period=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, n_ssm_heads=8),
    attn_period=8,
    attn_offset=4,           # attention mid-group, as in Jamba's block layout
    rope_theta=0.0,          # Jamba attention layers use no positional encoding
    group_size=8,
    source="arXiv:2403.19887; hf",
)
