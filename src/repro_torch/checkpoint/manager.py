"""Checkpoint lifecycle: periodic saves, keep-k GC, resume-from-latest
(port of ``repro/checkpoint/manager.py``).

The training driver (launch/train.py) uses this for fault tolerance:
on restart it resumes bit-exactly from the newest complete checkpoint
(atomicity guaranteed by ckpt.save's write-then-rename).
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Optional

from repro_torch.checkpoint import ckpt

_PAT = re.compile(r"ckpt_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, every: int = 50,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.every = every
        self.writer = ckpt.AsyncWriter() if async_write else None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> list[int]:
        out = []
        for p in glob.glob(os.path.join(self.dir, "ckpt_*.npz")):
            m = _PAT.search(p)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def maybe_save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every):
            return False
        if self.writer is not None:
            self.writer.save(self._path(step), step, tree)
        else:
            ckpt.save(self._path(step), step, tree)
        self._gc()
        return True

    def finalize(self) -> None:
        if self.writer is not None:
            self.writer.wait()
        self._gc()

    def restore_latest(self, template: Any) -> Optional[tuple[int, Any]]:
        if self.writer is not None:
            self.writer.wait()
        step = self.latest_step()
        if step is None:
            return None
        return ckpt.load(self._path(step), template)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except FileNotFoundError:
                pass
