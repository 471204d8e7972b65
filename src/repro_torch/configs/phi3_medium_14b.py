"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. 40L d_model=5120 40H (GQA
kv=10) d_ff=17920 vocab=100352 [arXiv:2404.14219; unverified].

Port of ``repro/configs/phi3_medium_14b.py`` (same values)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    head_dim=128,
    rope_theta=1e4,
    group_size=1,
    source="arXiv:2404.14219; unverified",
)
