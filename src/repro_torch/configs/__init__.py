"""Architecture registry of the port (``repro/configs/registry.py``).

The architectures the port can run are registered, in the reference's
order: the dense GQA ``llama3.2-3b``, ``phi3-medium-14b``, ``minicpm-2b``
and ``internlm2-20b``, the vision-fused ``pixtral-12b`` (d 160), the
encoder-only audio ``hubert-xlarge``, the MoE
``llama4-maverick-400b-a17b``, the hybrid Mamba/attention/MoE
``jamba-v0.1-52b`` and the mLSTM/sLSTM ``xlstm-350m``.  The MLA family
(``deepseek-v2-236b``) waits for ROADMAP Queue 1 item 7c.3.  ``reduced``
is the reference's CPU-smoke miniature.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.hubert_xlarge import CONFIG as _HUBERT_XLARGE
from repro_torch.configs.internlm2_20b import CONFIG as _INTERNLM2_20B
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _JAMBA_V0_1_52B
from repro_torch.configs.llama3_2_3b import CONFIG as _LLAMA3_2_3B
from repro_torch.configs.llama4_maverick_400b_a17b import \
    CONFIG as _LLAMA4_MAVERICK
from repro_torch.configs.minicpm_2b import CONFIG as _MINICPM_2B
from repro_torch.configs.phi3_medium_14b import CONFIG as _PHI3_MEDIUM_14B
from repro_torch.configs.pixtral_12b import CONFIG as _PIXTRAL_12B
from repro_torch.configs.xlstm_350m import CONFIG as _XLSTM_350M

_CONFIGS = {"jamba-v0.1-52b": _JAMBA_V0_1_52B, "llama3.2-3b": _LLAMA3_2_3B,
            "phi3-medium-14b": _PHI3_MEDIUM_14B, "minicpm-2b": _MINICPM_2B,
            "internlm2-20b": _INTERNLM2_20B, "pixtral-12b": _PIXTRAL_12B,
            "hubert-xlarge": _HUBERT_XLARGE,
            "llama4-maverick-400b-a17b": _LLAMA4_MAVERICK,
            "xlstm-350m": _XLSTM_350M}
# the reference's other architectures, and what they wait for
_NOT_PORTED = {
    "deepseek-v2-236b": "MLA attention (dk 192 with dv 128, a latent "
                        "cache, MoE top 6 of 160)",
}

ARCH_IDS = list(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch} is not ported: it needs {_NOT_PORTED[arch]} (ROADMAP "
            "Queue 1 item 7c.3)")
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    return _CONFIGS[arch]


def reduced(cfg: ModelConfig, seed_vocab: int = 512) -> ModelConfig:
    """Same-family miniature for CPU tests: one scan group, narrow width,
    few experts, tiny vocab (``registry.reduced`` of the JAX package)."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported (ROADMAP Queue 1 item 7c.3)")
    changes: dict = dict(
        n_layers=cfg.group_size,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=seed_vocab,
        head_dim=32,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
        remat=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=8, chunk=32,
                                             n_ssm_heads=2)
    if cfg.xlstm is not None:
        changes["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=32)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "reduced"]
