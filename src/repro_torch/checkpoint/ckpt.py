"""Atomic, optionally asynchronous checkpoints (port of
``repro/checkpoint/ckpt.py``).

Format: one ``.npz`` holding every tensor leaf keyed by its tree path
(``params/groups/0/mixer/wq``), the step, and a JSON manifest that tags
each leaf's torch dtype.  numpy has no bfloat16, and ``ml_dtypes`` is not
a dependency of the port, so a bf16 tensor is stored as its raw 16-bit
patterns (``uint16``) and the manifest's tag turns it back.  Writes go to
a temporary file, are fsynced, then ``os.replace``d: a checkpoint is
either fully present or absent, never torn.  ``AsyncWriter`` overlaps
the disk write with the next training steps (the device-to-host copy is
synchronous).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_unflatten

_STEP = "__step__"
_MANIFEST = "__manifest__"
# torch dtypes a leaf may have, by manifest tag
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "bool": torch.bool}
_TAGS = {v: k for k, v in _DTYPES.items()}


def _key(path) -> str:
    """``params/groups/0/mixer/wq`` from a pytree key path."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _to_host(tree) -> dict:
    """{path: (numpy array, dtype tag)}, every leaf copied to the host:
    in-place updates after the call cannot reach what is written."""
    out = {}
    for path, t in tree_flatten_with_path(tree)[0]:
        t = t.detach()
        tag = _TAGS[t.dtype]
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).to("cpu", copy=True).numpy()
            arr = arr.view(np.uint16)
        else:
            arr = t.to("cpu", copy=True).numpy()
        out[_key(path)] = (arr, tag)
    return out


def save(path: str, step: int, tree: Any) -> None:
    """Atomic synchronous save of a tree of tensors."""
    _write(path, step, _to_host(tree))


def _write(path: str, step: int, host: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: arr for key, (arr, _) in host.items()}
    manifest = {key: tag for key, (_, tag) in host.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **{_STEP: np.int64(step),
                       _MANIFEST: np.array(json.dumps(manifest))}, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str, template: Any) -> tuple[int, Any]:
    """(step, tree) with the structure of ``template``; each leaf has the
    dtype and device of the template's leaf, and must have its shape."""
    with np.load(path) as z:
        step = int(z[_STEP])
        manifest = json.loads(str(z[_MANIFEST]))
        flat = {k: z[k] for k in z.files if k not in (_STEP, _MANIFEST)}

    def restore(path, like):
        key = _key(path)
        arr = flat[key]
        if manifest[key] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    leaves, spec = tree_flatten_with_path(template)
    return step, tree_unflatten([restore(p, x) for p, x in leaves], spec)


class AsyncWriter:
    """Overlap disk writes with training: the copy to the host is
    synchronous (so the next step may update the tensors in place), the
    serialization and fsync run in a thread."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, path: str, step: int, tree: Any) -> None:
        self.wait()
        host_tree = _to_host(tree)

        def work():
            try:
                _write(path, step, host_tree)
            except BaseException as e:       # surfaces on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
