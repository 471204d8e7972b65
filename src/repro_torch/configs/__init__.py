"""Architecture registry of the port (``repro/configs/registry.py``).

Only the architectures the port can run are registered: the dense GQA
``llama3.2-3b`` and the hybrid Mamba/attention/MoE ``jamba-v0.1-52b``.
``reduced`` is the reference's CPU-smoke miniature.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _JAMBA_V0_1_52B
from repro_torch.configs.llama3_2_3b import CONFIG as _LLAMA3_2_3B

_CONFIGS = {"jamba-v0.1-52b": _JAMBA_V0_1_52B, "llama3.2-3b": _LLAMA3_2_3B}

ARCH_IDS = list(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    return _CONFIGS[arch]


def reduced(cfg: ModelConfig, seed_vocab: int = 512) -> ModelConfig:
    """Same-family miniature for CPU tests: one scan group, narrow width,
    few experts, tiny vocab (``registry.reduced`` of the JAX package)."""
    if cfg.mla or cfg.xlstm:
        raise NotImplementedError(
            f"{cfg.name}: MLA and xLSTM configs are not ported (ROADMAP "
            "Queue 1 item 7)")
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
    return dataclasses.replace(cfg, **changes)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "reduced"]
