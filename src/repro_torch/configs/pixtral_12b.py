"""pixtral-12b [vlm] — pixtral-ViT frontend + mistral-nemo decoder.
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].

The ViT frontend is a stub: batches carry precomputed patch embeddings
(n_frontend_tokens x d_model) that replace the first token positions at
embedding time (early fusion).  Head dim 160 = 5120 / 32.

Port of ``repro/configs/pixtral_12b.py`` (same values)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=160,
    frontend="vision",
    n_frontend_tokens=1024,   # one 1024-patch image per sequence
    rope_theta=1e9,
    group_size=1,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
