"""Architecture registry of the port (``repro/configs/registry.py``).

Only the architectures the port can run are registered: the dense GQA
``llama3.2-3b`` for now.  ``reduced`` is the reference's CPU-smoke
miniature, kept to the fields a dense GQA config uses.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.llama3_2_3b import CONFIG as _LLAMA3_2_3B

_CONFIGS = {"llama3.2-3b": _LLAMA3_2_3B}

ARCH_IDS = list(_CONFIGS)


def get_config(arch: str) -> ModelConfig:
    if arch not in _CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; the port knows {ARCH_IDS}")
    return _CONFIGS[arch]


def reduced(cfg: ModelConfig, seed_vocab: int = 512) -> ModelConfig:
    """Same-family miniature for CPU tests: one scan group, narrow width,
    tiny vocab (``registry.reduced`` of the JAX package)."""
    if cfg.moe or cfg.mla or cfg.ssm or cfg.xlstm:
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA configs are ported (ROADMAP "
            "Queue 1 item 7)")
    return dataclasses.replace(
        cfg,
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


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "reduced"]
