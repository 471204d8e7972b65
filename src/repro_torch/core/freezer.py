"""Freeze/thaw with state offload — the cgroup.freeze analogue.

Port of ``repro/core/freezer.py`` over torch tensors.  Freezing a
session must release the contended resource (device KV pages) while
preserving the session's accumulated context, so freeze = copy the
state to host memory + park; thaw = hand it back for re-upload.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


def _host_copy(tree):
    """A host (CPU) copy of a dict/list tree of tensors."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@dataclass
class FrozenEntry:
    session_id: str
    blobs: Any                   # host tree of CPU tensors
    pages: int                   # pages the session held when frozen
    meta: dict
    frozen_at: float             # caller's step clock, never wall time:
                                 # records must be replay-deterministic


class FrozenStore:
    """Host-memory swap space for frozen sessions' device state."""

    def __init__(self) -> None:
        self._entries: dict[str, FrozenEntry] = {}
        self.n_freezes = 0
        self.n_thaws = 0
        self.bytes_held = 0
        # chaos seam: called with the session id after the host copy
        # but BEFORE the entry commits; a raise aborts the freeze with
        # the store unchanged (never a partial entry) — see
        # ``FaultyBackend.offload_fault``
        self.offload_hook: Optional[Any] = None

    def freeze(self, session_id: str, device_tree: Any, *, pages: int,
               meta: Optional[dict] = None, now: float = 0.0) -> None:
        """Offload a tree of device tensors to host memory.  ``now`` is
        the caller's logical clock (engine step number).

        Transactional: the entry (and the freeze/bytes accounting)
        commits only after the whole device->host copy, and the
        ``offload_hook`` chaos seam, succeeded, so a transient
        mid-offload failure leaves the store exactly as it was."""
        if session_id in self._entries:
            raise KeyError(f"{session_id} is already frozen")
        host = _host_copy(device_tree)
        if self.offload_hook is not None:
            self.offload_hook(session_id)      # may raise: nothing committed
        self._entries[session_id] = FrozenEntry(
            session_id, host, pages, meta or {}, float(now))
        self.n_freezes += 1
        self.bytes_held += _nbytes(host)

    def thaw(self, session_id: str) -> FrozenEntry:
        """Return the offloaded state (caller re-uploads / re-charges)."""
        e = self._entries.pop(session_id)
        self.n_thaws += 1
        self.bytes_held -= _nbytes(e.blobs)
        return e

    def is_frozen(self, session_id: str) -> bool:
        return session_id in self._entries

    def frozen_ids(self) -> list[str]:
        return list(self._entries)

    def pages_held(self, session_id: str) -> int:
        return self._entries[session_id].pages
