"""Tensors that hold no data, through the kernel wrappers.

A meta tensor, or a ``FakeTensor`` of ``torch._subclasses`` (whose
storage lies on the meta device whatever device it reports), carries a
shape, a dtype and a device and nothing else.  Each wrapper of this
package takes such tensors down a branch of its own: it checks them as
its CUDA branch does, allocates exactly the outputs (and scratch) that
branch allocates, records its kernel's name and ``cost(...)`` with the
active recorder, and returns, building and launching nothing and leaving
its ``launches`` count alone.  The dry run (``launch/dryrun.py``) traces
a whole step this way: ``analysis/costs.py::CostCounter`` is the
recorder, and sees every aten op besides.
"""
from __future__ import annotations

import contextvars

import torch

# the active recorder: a callable (name, cost) -> None, or None
_RECORDER = contextvars.ContextVar("repro_torch_kernel_recorder",
                                   default=None)


def holds_data(t: torch.Tensor) -> bool:
    """False for a meta tensor or a tensor whose storage is on the meta
    device (a fake tensor); True for any tensor with memory behind it."""
    if type(t) is torch.Tensor:
        return not t.is_meta
    return t.untyped_storage().device.type != "meta"


def record(name: str, cost: dict) -> None:
    """Give one kernel call that did not run (``holds_data`` False) to
    the active recorder, if there is one."""
    recorder = _RECORDER.get()
    if recorder is not None:
        recorder(name, cost)


def set_recorder(recorder):
    """Make ``recorder`` the active one; returns the token that
    ``reset_recorder`` takes to restore the one before."""
    return _RECORDER.set(recorder)


def reset_recorder(token) -> None:
    _RECORDER.reset(token)
