"""Async lifecycle daemon: the fourth ``Backend`` (paper §4.2 / §5).

Port of ``repro/core/daemon.py``.  The paper's responsiveness mismatch
splits resource control in two: per-allocation *enforcement* stays on
the hot path (inside the engine's step, via ``device_view()``), while
*lifecycle* work (domain creation/removal, limit writes, freeze/thaw,
program attach/retune, intent-lease open/close) belongs to a user-space
daemon that must never block that path.  ``AsyncDaemonBackend`` is that
daemon: a wrapper around any inner ``Backend`` (host / device / sharded)
that moves every lifecycle op onto a dedicated daemon thread behind a
FIFO command queue.

Semantics, chosen so the wrapper is *bit-exact* with its inner backend
run synchronously:

  * **FIFO epochs.**  Commands apply strictly in submission order, in
    batches ("epochs").  In the default *deferred* mode an epoch runs
    only when something demands it: an explicit ``flush()`` /
    ``barrier()`` (the engine calls one per step, at the step boundary),
    a read, or a result-bearing op.  With ``eager=True`` the daemon
    drains the queue as soon as commands arrive (same order, same
    results, different wall-clock).
  * **Fire-and-forget ops** (``write``, ``freeze``, ``thaw``,
    ``uncharge``, ``charge_unchecked``, ``update_params``, ``attach``,
    ``set_time``) enqueue and return immediately.  An op that fails on
    the daemon thread is held and re-raised as ``DaemonError`` at the
    next ``flush()``.
  * **Result-bearing ops** (``mkdir``, ``rmdir``, ``kill``,
    ``try_charge``, ``schedule``) enqueue, fence the queue up to
    themselves, and wait for their own completion: the work still runs
    on the daemon thread, after everything queued before it.
  * **Reads are snapshot-consistent**: ``read``/``exists``/``paths``/
    ``snapshot`` first flush, then delegate, so they always observe a
    whole number of epochs; ``snapshot()`` is tagged with the ``epoch``
    it reflects.
  * **Deadlocks fail fast**: waits carry a liveness check plus a
    ``flush_timeout_s`` ceiling and raise ``DaemonError`` instead of
    hanging the caller.  A timed-out wait also *poisons* the backend:
    the stuck command cannot be cancelled and may still apply once the
    daemon unwedges, so every later submit/flush raises until the
    backend is closed and rebuilt.

**The stream rule.**  On a card, the current device and the current
stream are per thread, and the kernel wrappers launch on the calling
thread's current stream.  The daemon thread therefore applies every
batch under the inner backend's device and the stream that was current
where the backend was built (captured at construction): the lifecycle
writes to a device table are issued, in order, on the stream the
engine's step later reads the table from, so a ``flush()`` returning
orders them before that step without synchronizing the device.

The enforcement hot path is untouched: ``device_view()`` returns the
*inner* backend's view, whose ``charge``/``account``/``gate`` the step
calls; the daemon only mutates state between epochs, which the engine
aligns with step boundaries.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.cgroup import ChargeTicket, DomainSpec
from repro_torch.core.events import EventLog
from repro_torch.core.progs import PolicyProgram


def _build_stream(inner) -> Optional[torch.cuda.Stream]:
    """The stream current on the inner backend's card where the daemon
    is built; None for a backend without device state or on the CPU."""
    dev = getattr(inner, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return None
    return torch.cuda.current_stream(torch.device(dev))


def _on_stream(stream: Optional[torch.cuda.Stream]) -> ExitStack:
    """Make ``stream`` (and its device) current on this thread."""
    ctx = ExitStack()
    if stream is not None:
        ctx.enter_context(torch.cuda.device(stream.device))
        ctx.enter_context(torch.cuda.stream(stream))
    return ctx


class DaemonError(RuntimeError):
    """A queued lifecycle op failed, the daemon thread died, or a wait
    exceeded ``flush_timeout_s`` (wedged daemon)."""


@dataclass
class _Cmd:
    seq: int
    name: str
    args: tuple
    done: Optional[threading.Event]          # set for result-bearing ops
    result: Any = None
    error: Optional[BaseException] = None


class AsyncDaemonBackend:
    """Wraps any inner ``Backend``; lifecycle ops run on a daemon thread
    in FIFO epochs.  See module docstring for the exact semantics."""

    _POLL_S = 0.05                           # liveness-check granularity

    def __init__(self, inner, *, eager: bool = False,
                 flush_timeout_s: float = 60.0):
        self.inner = inner
        self.eager = bool(eager)
        self.flush_timeout_s = float(flush_timeout_s)
        self.epoch = 0                       # completed apply batches
        self._cv = threading.Condition()
        # held by the daemon while a batch applies and by flushing
        # reads while they observe the inner backend: reads see whole
        # epochs even with concurrent submitters (eager mode, threads)
        self._apply_lock = threading.Lock()
        self._queue: deque[_Cmd] = deque()
        self._submitted = 0                  # seq of last enqueued command
        self._applied = 0                    # seq of last applied command
        self._fence = 0                      # daemon may apply seq <= fence
        self._errors: list[tuple[str, BaseException]] = []
        self._closed = False
        self._wedged = False                 # a wait timed out: state unknown
        self._stream = _build_stream(inner)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="agentcgroup-daemon")
        self._thread.start()

    # ------------------------------------------------------------ the daemon

    def _runnable(self) -> bool:
        return bool(self._queue) and self._queue[0].seq <= self._fence

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not self._runnable():
                    self._cv.wait()
                if self._closed and not self._runnable():
                    return
                batch = []
                while self._queue and self._queue[0].seq <= self._fence:
                    batch.append(self._queue.popleft())
            # outside _cv: real work, on the device and stream captured
            # where this daemon was built
            with self._apply_lock, _on_stream(self._stream):
                for cmd in batch:
                    try:
                        cmd.result = getattr(self.inner, cmd.name)(*cmd.args)
                    except BaseException as e:  # noqa: BLE001 — repost
                        cmd.error = e
                        if cmd.done is None:
                            with self._cv:
                                self._errors.append((cmd.name, e))
                    finally:
                        if cmd.done is not None:
                            cmd.done.set()
                # bookkeeping inside the apply lock: a reader holding it
                # sees state and epoch tag move together, never state of
                # epoch N+1 stamped as epoch N
                with self._cv:
                    self._applied = batch[-1].seq
                    self.epoch += 1          # one epoch per drained batch
                    self._cv.notify_all()

    def _submit(self, name: str, *args, want_result: bool = False):
        done = threading.Event() if want_result else None
        with self._cv:
            if self._closed:
                raise DaemonError("backend is closed")
            if self._wedged:
                raise DaemonError("daemon previously timed out; state is "
                                  "unknown — close and rebuild the backend")
            if not self._thread.is_alive():
                raise DaemonError("daemon thread died")
            self._submitted += 1
            cmd = _Cmd(self._submitted, name, args, done)
            self._queue.append(cmd)
            if self.eager or want_result:
                self._fence = self._submitted
            self._cv.notify_all()
        if not want_result:
            return None
        deadline = time.monotonic() + self.flush_timeout_s
        while not done.wait(timeout=self._POLL_S):
            if not self._thread.is_alive():
                raise DaemonError(f"daemon thread died applying {name!r}")
            if time.monotonic() > deadline:
                # the command cannot be safely cancelled (it may apply
                # later, once the daemon unwedges) — poison the backend
                # so no caller keeps using state it can no longer trust
                self._wedged = True
                raise DaemonError(
                    f"{name!r} timed out after {self.flush_timeout_s}s "
                    "(wedged daemon?); backend poisoned — close and "
                    "rebuild")
        if cmd.error is not None:
            raise cmd.error
        return cmd.result

    # ------------------------------------------------------- epoch control

    def flush(self) -> int:
        """Apply every command queued so far (one epoch), re-raise any
        deferred-op failure, and return the epoch now reflected."""
        with self._cv:
            if self._closed:
                raise DaemonError("backend is closed")
            if self._wedged:
                raise DaemonError("daemon previously timed out; state is "
                                  "unknown — close and rebuild the backend")
            target = self._submitted
            if self._fence < target:
                self._fence = target
                self._cv.notify_all()
            deadline = time.monotonic() + self.flush_timeout_s
            while self._applied < target:
                if not self._thread.is_alive():
                    raise DaemonError("daemon thread died with work queued")
                if time.monotonic() > deadline:
                    self._wedged = True      # queued work may apply later
                    raise DaemonError(
                        f"flush timed out after {self.flush_timeout_s}s "
                        "(wedged daemon?); backend poisoned — close and "
                        "rebuild")
                self._cv.wait(timeout=self._POLL_S)
            errors, self._errors = self._errors, []
            epoch = self.epoch
        if errors:
            name, first = errors[0]
            raise DaemonError(
                f"{len(errors)} deferred lifecycle op(s) failed; "
                f"first: {name}: {first!r}") from first
        return epoch

    barrier = flush                          # deterministic-replay alias

    def close(self, *, flush: bool = True) -> None:
        """Stop the daemon thread.  By default drains the queue first;
        ``flush=False`` drops whatever is still queued."""
        if self._closed:
            return
        try:
            if flush and not self._wedged and self._thread.is_alive():
                self.flush()             # may raise a deferred DaemonError
        finally:                         # ...but the daemon always stops
            with self._cv:
                self._closed = True
                if not flush:
                    self._queue.clear()
                self._cv.notify_all()
            self._thread.join(timeout=self.flush_timeout_s)

    def __enter__(self) -> "AsyncDaemonBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc == (None, None, None))

    # ------------------------------------------------- Backend: lifecycle

    def attach(self, scope: str, prog: PolicyProgram) -> None:
        self._submit("attach", scope, prog)

    def update_params(self, path: str, kv: dict) -> None:
        self._submit("update_params", path, kv)

    def mkdir(self, path: str, spec: DomainSpec) -> int:
        return self._submit("mkdir", path, spec, want_result=True)

    def rmdir(self, path: str, transfer_residual: bool) -> int:
        return self._submit("rmdir", path, transfer_residual,
                            want_result=True)

    def kill(self, path: str) -> int:
        return self._submit("kill", path, want_result=True)

    def freeze(self, path: str) -> None:
        self._submit("freeze", path)

    def thaw(self, path: str) -> None:
        self._submit("thaw", path)

    def write(self, path: str, file: str, value) -> None:
        self._submit("write", path, file, value)

    def set_time(self, t: float) -> None:
        self._submit("set_time", t)

    # -------------------------------------------------- Backend: charging

    def try_charge(self, path: str, pages: int,
                   step: Optional[int]) -> ChargeTicket:
        return self._submit("try_charge", path, pages, step,
                            want_result=True)

    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list:
        """Result-bearing like ``try_charge``: the round runs on the
        daemon after everything queued before it (a weight write queued
        earlier lands before the slots are ranked)."""
        return self._submit("schedule", paths, costs, step, budget,
                            want_result=True)

    def uncharge(self, path: str, pages: int) -> None:
        self._submit("uncharge", path, pages)

    def charge_unchecked(self, path: str, pages: int) -> None:
        self._submit("charge_unchecked", path, pages)

    # ------------------------------------------- Backend: reads (flushing)

    def _observe(self, fn, *args):
        """Flush, then observe the inner backend under the apply lock:
        even with concurrent submitters (eager mode, other threads) a
        read never sees a batch mid-application — always a whole number
        of epochs."""
        self.flush()
        with self._apply_lock:
            return fn(*args)

    def exists(self, path: str) -> bool:
        return self._observe(lambda: self.inner.exists(path))

    def paths(self) -> list[str]:
        return self._observe(lambda: self.inner.paths())

    def handle(self, path: str) -> int:
        return self._observe(lambda: self.inner.handle(path))

    def path_of(self, handle: int) -> str:
        return self._observe(lambda: self.inner.path_of(handle))

    def read(self, path: str, file: str):
        return self._observe(lambda: self.inner.read(path, file))

    def snapshot(self) -> dict:
        """Inner snapshot tagged with the epoch it reflects."""

        def take():
            snap = self.inner.snapshot()
            snap["epoch"] = self.epoch
            return snap

        return self._observe(take)

    @property
    def log(self) -> EventLog:
        return self._observe(lambda: self.inner.log)

    @property
    def prog(self) -> PolicyProgram:
        return self._observe(lambda: self.inner.prog)

    @property
    def progs(self) -> tuple:
        return self._observe(lambda: self.inner.progs)

    def device_view(self):
        """The INNER backend's jit-safe view: in-step enforcement never
        goes through the queue (the daemon only mutates between epochs,
        which the engine aligns with step boundaries)."""
        return self._observe(lambda: self.inner.device_view())

    def __getattr__(self, name: str):
        # backend-specific read-only extras (placement, index, tree,
        # table, n_shards, throttle_delay_ms, ...): the attribute fetch
        # observes a whole number of epochs; invoking a returned bound
        # method runs outside the epoch lock (single-writer callers
        # only, like everything engine-facing)
        if name.startswith("_") or "inner" not in self.__dict__:
            raise AttributeError(name)
        return self._observe(lambda: getattr(self.inner, name))
