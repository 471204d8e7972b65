"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared / 160 routed
top-6 experts.  60L d_model=5120 128H d_ff_expert=1536 vocab=102400
[arXiv:2405.04434; hf].

This is the JAX package's form of the model, the twin that the parity
tests hold the port to: every layer is MoE with d_ff=1536 experts (the
official model's single first dense layer is folded into the MoE stack),
the top-6 gates are renormalised, routing is greedy over all 160 experts
(no groups, no ``routed_scaling_factor``) and the rope has no YaRN.  The
published form (a leading dense layer of 12,288, group-limited routing
over 8 groups, top-3 groups, gates times 16 not renormalised, YaRN with
factor 40, and one card's 20-expert share of a 30-layer stage) is
``portbench/configs/deepseek-v2-236b.json``, which the port builds
through the init-only fields of ``MoEConfig`` and ``MLAConfig``.
MLA caches a 512+64 latent per token: the KV cache is ~9x smaller than
GQA kv=128 would be.  Attention runs at dk 192 (128 + 64 rope) / dv 128.

Port of ``repro/configs/deepseek_v2_236b.py`` (same values)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # nominal; MLA replaces per-head KV with the latent
    d_ff=1536,
    vocab=102400,
    head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  period=1),
    rope_theta=1e4,
    group_size=1,
    source="arXiv:2405.04434; hf",
)
