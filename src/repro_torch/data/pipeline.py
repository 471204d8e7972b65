"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``, numpy only).

Batches are a pure function of (seed, step): restart-safe without data
state in checkpoints — after resume, step N yields bit-identical batches,
the same ones the JAX package draws (``SeedSequence([seed, step])``).
Documents are variable-length and packed into fixed sequences with EOS
boundaries; loss weights mask the joins and a vision model's patch
positions.  Audio (encoder-only) batches carry frame embeddings and a
mask for masked-frame prediction; vision batches carry patch embeddings.
The reference's sharding helpers (a mesh concern) are not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

EOS = 1


def _doc_lengths(rng: np.random.Generator, total: int) -> list[int]:
    """Pack variable-length 'documents' (lognormal lengths) into total."""
    out, used = [], 0
    while used < total:
        ln = int(np.clip(rng.lognormal(5.0, 1.0), 16, total - used or 16))
        ln = min(ln, total - used)
        out.append(ln)
        used += ln
    return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, seed: int,
               step: int, batch: Optional[int] = None,
               seq: Optional[int] = None) -> dict:
    """One training batch as numpy (host) arrays: tokens, labels (i32)
    and weights (f32), each (B, S); a vision model's batch adds patches
    (B, n_frontend_tokens, d) f32, with no loss weight on the first
    positions they replace.  An audio model's batch is frames (B, S, d)
    f32, a bool mask (B, S), labels and weights = the mask.  The draws
    are the reference's, in its order."""
    B = batch or shape.global_batch
    S = seq or shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.frontend == "audio":
        frames = rng.standard_normal((B, S, cfg.d_model), np.float32)
        mask = rng.random((B, S)) < 0.3           # masked-prediction targets
        labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int64)
        return {"frames": frames, "mask": mask,
                "labels": labels.astype(np.int32),
                "weights": mask.astype(np.float32)}
    # learnable documents: a SEED-fixed bigram permutation with a noise
    # floor — stable across steps, so CE falls below ln(V) within tens
    # of steps on the reduced configs
    V = cfg.vocab - 2
    perm = np.random.default_rng(seed ^ 0x5EED).permutation(V)
    toks = np.empty((B, S + 1), np.int64)
    noise = rng.random((B, S + 1)) < 0.1
    toks[:, 0] = rng.integers(0, V, B)
    for i in range(1, S + 1):
        nxt = perm[toks[:, i - 1]]
        rnd = rng.integers(0, V, B)
        toks[:, i] = np.where(noise[:, i], rnd, nxt)
    toks += 2
    weights = np.ones((B, S), np.float32)
    for b in range(B):
        pos = 0
        for ln in _doc_lengths(rng, S + 1):
            end = pos + ln
            if end <= S:
                toks[b, end - 1] = EOS
                weights[b, end - 1] = 0.0          # no loss across doc joins
            pos = end
    out = {"tokens": toks[:, :S].astype(np.int32),
           "labels": toks[:, 1:S + 1].astype(np.int32),
           "weights": weights}
    if cfg.frontend == "vision":
        n = min(cfg.n_frontend_tokens, S)
        out["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        weights[:, :n] = 0.0                       # no LM loss on patches
    return out


class DataIterator:
    """Stateless-by-construction iterator: ``at(step)`` is pure, and
    gives the batch as tensors on ``device`` (an audio batch's mask
    stays bool)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, device,
                 seed: int = 0, batch: Optional[int] = None,
                 seq: Optional[int] = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.batch, self.seq = batch, seq
        self.device = torch.device(device)

    def at(self, step: int) -> dict:
        b = make_batch(self.cfg, self.shape, seed=self.seed, step=step,
                       batch=self.batch, seq=self.seq)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
