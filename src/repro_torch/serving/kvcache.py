"""KV cache management + page accounting for the serving engine.

Port of ``repro/serving/kvcache.py``:
  * ``PageAccountant`` — maps context length to page counts (the charge
    unit of the resource domains; 1 page = ``page_tokens`` tokens).
  * ``SlotCaches`` — the dense per-slot decode state
    (``model.decode_state``: attention caches and recurrent states, every
    leaf ``[group, slot, ...]``), with freeze/thaw slot offload to a
    ``FrozenStore`` in host memory and slot recycling.  The engine runs
    this dense layout; the paged-decode kernel
    (``kernels/decode_attention.py::paged_decode_attention``) exists,
    but no pool of pages is wired into the engine yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import resolve_device
from repro_torch.core.freezer import FrozenStore
from repro_torch.models import model as M


@dataclass(frozen=True)
class PageAccountant:
    page_tokens: int = 16

    def pages_for(self, n_tokens: int) -> int:
        return math.ceil(max(n_tokens, 1) / self.page_tokens)

    def crossing(self, length: int) -> int:
        """Pages that must be charged to append token #length (0-based)."""
        return 1 if length % self.page_tokens == 0 else 0


def check_servable(cfg: ModelConfig) -> None:
    """The engine serves decoders of attention (GQA or MLA), Mamba, mLSTM
    and sLSTM layers: each state leaf is ``[group, slot, ...]`` -- a GQA
    cache ``{k, v}: [group, slot, S_max, Hkv, hd]``, an MLA latent cache
    ``{ckv: [group, slot, S_max, L], krope: [group, slot, S_max, rd]}``,
    a recurrent state ``[group, slot, ...]`` -- so the gated merge
    (``serving/engine.py``, which saves and restores row ``lengths[b]`` of
    each attention leaf at that leaf's rank), ``free_slot`` and
    freeze/thaw carry every layout by its slot axis.  A vision model is
    served as the reference's engine serves it: it decodes text tokens
    (the patches enter a forward, not a decode step).  An encoder-only
    model has no decode step (the reference's reason)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only; no decode step")


class SlotCaches:
    """Dense per-slot decode state with host offload."""

    def __init__(self, cfg: ModelConfig, max_slots: int, s_max: int,
                 device="cuda"):
        check_servable(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.s_max = s_max
        self.state = M.decode_state(cfg, max_slots, s_max, device)
        self._free = list(range(max_slots))
        self.store = FrozenStore()

    # ------------------------------------------------------------- slots

    def alloc_slot(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def free_slot(self, slot: int) -> None:
        # zero the slot's state so a recycled slot starts clean
        for pos in self.state:
            for t in pos.values():
                t[:, slot].zero_()
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    # ----------------------------------------------------- freeze / thaw

    def freeze_slot(self, session_id: str, slot: int, *, pages: int,
                    meta: Optional[dict] = None, now: float = 0.0) -> None:
        """Offload one slot's state to host memory and recycle the slot."""
        blob = [{k: t[:, slot] for k, t in pos.items()} for pos in self.state]
        self.store.freeze(session_id, blob, pages=pages, meta=meta, now=now)
        self.free_slot(slot)

    def thaw_slot(self, session_id: str) -> tuple[int, dict]:
        """Restore a frozen session into a fresh slot."""
        slot = self.alloc_slot()
        if slot is None:
            raise RuntimeError("no free slot to thaw into")
        entry = self.store.thaw(session_id)
        for pos, blob in zip(self.state, entry.blobs):
            for k, t in pos.items():
                t[:, slot].copy_(blob[k])
        return slot, entry.meta
