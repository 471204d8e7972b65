"""The port's async lifecycle daemon (``repro_torch/core/daemon.py``):
twins of the reference's daemon tests (``tests/test_daemon.py``): FIFO
epochs and deferred batching, work on the daemon thread, snapshot epoch
tags, deferred errors at flush, close, eager mode, fail-fast on a wedged
daemon and recovery from a snapshot, and the residual-transfer-exactly-
once regressions on all six backend kinds (the device-state kinds on
the CPU), each against the JAX package's answer on the same ops.

Wedges are ``threading.Event``s and no test sleeps to wait for a
result.  A wedge test builds its daemon with the default timeout, runs
its set-up ops, and lowers ``flush_timeout_s`` only just before the
wedged wait, so that nothing but the wedge can trip it."""
import threading
import time

import pytest
torch = pytest.importorskip("torch")

from repro.core import cgroup as JC
from repro.core import daemon as JDm
from repro.testing import conformance as JK
from repro_torch.core import domains as D
from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                     DomainSpec, HostTreeBackend)
from repro_torch.core.daemon import AsyncDaemonBackend, DaemonError
from repro_torch.core.sharded import ShardedTableBackend
from repro_torch.testing.conformance import (BACKEND_KINDS,
                                             standard_backend_factory)


class SpyInner:
    """Transparent wrapper recording (method, thread-id) per applied op,
    with optional per-method gates that block until released and
    per-method events set once the op applied."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = []
        self.gates: dict[str, threading.Event] = {}
        self.applied_events: dict[str, threading.Event] = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr) or name.startswith("_"):
            return attr

        def wrapper(*a, **k):
            gate = self.gates.get(name)
            if gate is not None:
                assert gate.wait(timeout=30.0), f"gate for {name} never set"
            self.calls.append((name, threading.get_ident()))
            out = attr(*a, **k)
            done = self.applied_events.get(name)
            if done is not None:
                done.set()
            return out

        return wrapper

    def applied(self, name):
        return [c for c in self.calls if c[0] == name]


def mk_async(eager=False):
    spy = SpyInner(HostTreeBackend(500))
    be = AsyncDaemonBackend(spy, eager=eager)
    return AgentCgroup(be), be, spy


# ----------------------------------------------------------- epochs / FIFO


def test_deferred_ops_batch_into_one_epoch_in_order():
    cg, be, spy = mk_async()
    cg.mkdir("/s")                        # result op: applies immediately
    e0 = be.flush()
    cg.write("/s", "memory.high", 50)
    cg.freeze("/s")
    cg.thaw("/s")
    # deferred mode: nothing applied until the epoch boundary
    assert not spy.applied("write") and not spy.applied("freeze")
    e1 = be.flush()
    assert e1 == e0 + 1                   # three ops -> ONE epoch
    names = [n for n, _ in spy.calls]
    i_w, i_f, i_t = (names.index(x) for x in ("write", "freeze", "thaw"))
    assert i_w < i_f < i_t                # FIFO order preserved
    assert cg.read("/s", "memory.high") == 50
    assert cg.read("/s", "cgroup.freeze") == 0
    be.close()


def test_mutations_run_on_daemon_thread_not_caller():
    cg, be, spy = mk_async()
    cg.mkdir("/s")
    cg.freeze("/s")
    cg.try_charge("/s", 5)
    be.flush()
    tids = {t for n, t in spy.calls if n in {"mkdir", "freeze",
                                             "try_charge"}}
    assert tids == {be._thread.ident}
    assert threading.get_ident() not in tids
    be.close()


def test_fire_and_forget_never_blocks_caller():
    """A lifecycle op whose inner application is blocked still returns
    to the caller at once."""
    cg, be, spy = mk_async()
    cg.mkdir("/s")
    be.flush()
    spy.gates["freeze"] = threading.Event()          # block the apply
    t0 = time.perf_counter()
    cg.freeze("/s")                                  # enqueue only
    assert time.perf_counter() - t0 < 0.5
    assert not spy.applied("freeze")
    spy.gates["freeze"].set()
    be.flush()
    assert spy.applied("freeze")
    assert cg.read("/s", "cgroup.freeze") == 1
    be.close()


def test_reads_flush_and_snapshot_is_epoch_tagged():
    cg, be, spy = mk_async()
    cg.mkdir("/s")
    cg.write("/s", "memory.high", 70)                # queued
    assert cg.read("/s", "memory.high") == 70        # read forced the epoch
    snap = cg.snapshot()
    assert snap["epoch"] == be.epoch
    assert snap["usage"][snap["index"]["/s"]] == 0
    be.close()


def _result_ops(cg, DS) -> list:
    out = [cg.mkdir("/s"), cg.mkdir("/s/tool", DS(high=40)),
           cg.try_charge("/s/tool", 30).granted, cg.mkdir("/k")]
    cg.charge_unchecked("/k", 7)
    out += [cg.handle("/s"), cg.rmdir("/s/tool"), cg.kill("/k"),
            cg.usage("/")]
    return out


def test_result_ops_match_synchronous_backend():
    """Result-bearing ops through the daemon: the synchronous host tree's
    answers, and the JAX package's daemon's."""
    cg, be, _ = mk_async()
    got = _result_ops(cg, DomainSpec)
    assert got == _result_ops(AgentCgroup(HostTreeBackend(500)), DomainSpec)
    jbe = JDm.AsyncDaemonBackend(JC.HostTreeBackend(500))
    assert got == _result_ops(JC.AgentCgroup(jbe), JC.DomainSpec)
    assert got[-3:] == [30, 7, 30]
    jbe.close()
    be.close()


# ------------------------------------------------------------------ errors


def test_deferred_error_surfaces_at_next_flush():
    cg, be, _ = mk_async()
    cg.mkdir("/s")
    be.flush()
    be.write("/s", "not.a.file", 1)       # bypass facade validation
    with pytest.raises(DaemonError) as ei:
        be.flush()
    assert isinstance(ei.value.__cause__, KeyError)
    # the daemon survives a bad op: the backend stays usable
    assert cg.try_charge("/s", 5).granted
    be.close()


def test_result_op_error_propagates_directly():
    cg, be, _ = mk_async()
    with pytest.raises(KeyError):
        be.rmdir("/nope", True)
    be.close()


def test_close_stops_daemon_even_when_drain_flush_raises():
    cg, be, _ = mk_async()
    cg.mkdir("/s")
    be.write("/s", "not.a.file", 1)       # deferred failure pending
    with pytest.raises(DaemonError):
        be.close()
    assert not be._thread.is_alive()
    with pytest.raises(DaemonError, match="closed"):
        cg.freeze("/s")


def test_submit_after_close_raises():
    cg, be, _ = mk_async()
    be.close()
    with pytest.raises(DaemonError):
        cg.freeze("/")


def test_wedged_daemon_fails_fast_not_hangs():
    """A stuck inner op makes flush raise DaemonError within the timeout
    instead of deadlocking the caller; the backend is then poisoned."""
    cg, be, spy = mk_async()
    cg.mkdir("/s")
    be.flush()
    spy.gates["freeze"] = threading.Event()          # never set -> wedged
    cg.freeze("/s")
    be.flush_timeout_s = 0.3                         # only the wedge trips
    t0 = time.perf_counter()
    with pytest.raises(DaemonError, match="timed out"):
        be.flush()
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(DaemonError, match="close and rebuild"):
        cg.freeze("/s")
    with pytest.raises(DaemonError, match="close and rebuild"):
        be.flush()
    spy.gates["freeze"].set()                        # unwedge + clean up
    be.close()
    assert not be._thread.is_alive()


def test_wedged_daemon_recovery_from_snapshot():
    """The rebuild contract: a backend rebuilt from the last good
    ``snapshot()`` carries identical control state, and continued ops on
    it bit-match an unpoisoned synchronous twin."""
    spy = SpyInner(HostTreeBackend(500))
    be = AsyncDaemonBackend(spy)
    cg = AgentCgroup(be)
    twin = AgentCgroup(HostTreeBackend(500))
    for c in (cg, twin):
        c.mkdir("/t", DomainSpec(high=200))
        c.mkdir("/t/s", DomainSpec(high=60, priority=D.HIGH))
        c.try_charge("/t/s", 40, step=0)
        c.write("/t/s", "memory.high", 80)
    snap = cg.snapshot()                     # last known-good state
    spy.gates["freeze"] = threading.Event()  # wedge the daemon
    cg.freeze("/t/s")
    be.flush_timeout_s = 0.3                 # only the wedge trips it
    with pytest.raises(DaemonError):
        cg.flush()
    with pytest.raises(DaemonError):
        cg.mkdir("/t/x")                     # poisoned, loudly
    fresh = HostTreeBackend(500)
    fresh.restore(snap)
    be2 = AsyncDaemonBackend(fresh)
    cg.backend = be2
    snap2 = cg.snapshot()
    for key in ("paths", "usage", "peak", "high", "max", "low",
                "priority", "frozen", "killed"):
        assert list(snap2[key]) == list(snap[key]), key
    for c in (cg, twin):
        c.try_charge("/t/s", 30, step=1)
        c.freeze("/t/s")
        c.thaw("/t/s")
        c.uncharge("/t/s", 20)
        c.try_charge("/t/s", 100, step=2)    # over high: same decision
    for path in ("/", "/t", "/t/s"):
        for f in ("memory.current", "memory.peak", "memory.high",
                  "cgroup.freeze"):
            assert cg.read(path, f) == twin.read(path, f), (path, f)
    spy.gates["freeze"].set()                # let the old daemon drain
    be.close(flush=False)
    be2.close()


# -------------------------------------------------------------- eager mode


def test_eager_mode_applies_without_flush():
    cg, be, spy = mk_async(eager=True)
    cg.mkdir("/s")
    applied = threading.Event()
    spy.applied_events["write"] = applied
    cg.write("/s", "memory.high", 99)
    assert applied.wait(timeout=10.0)                # no flush needed
    assert be._thread.ident in {t for _, t in spy.calls}
    assert cg.read("/s", "memory.high") == 99
    be.close()


def test_eager_reads_never_observe_mid_batch_state():
    """Reads from another thread while the eager daemon applies a stream
    of lifecycle ops always see whole epochs."""
    cg = AgentCgroup(AsyncDaemonBackend(HostTreeBackend(10_000),
                                        eager=True))
    cg.mkdir("/t")
    stop = threading.Event()
    errors: list[BaseException] = []

    def reader():
        try:
            while not stop.is_set():
                snap = cg.snapshot()
                assert snap["epoch"] <= cg.backend.epoch
                for p in cg.paths():
                    try:
                        cg.read(p, "memory.current")
                    except KeyError:
                        pass             # rmdir'd between reads: fine
        except BaseException as e:           # noqa: BLE001 — surfaced below
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(120):
            cg.mkdir(f"/t/s{i}")
            cg.charge_unchecked(f"/t/s{i}", 3)
            if i % 3 == 0:
                cg.rmdir(f"/t/s{i}")
    finally:
        stop.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert not errors, errors[0]
    assert cg.usage("/t") == 3 * 120      # rmdir moved residuals up
    cg.backend.close()


def test_context_manager_closes():
    with AsyncDaemonBackend(HostTreeBackend(100)) as be:
        AgentCgroup(be).mkdir("/s")
    assert not be._thread.is_alive()
    with pytest.raises(DaemonError):
        be.flush()


def test_daemon_takes_its_constructors_device_and_stream():
    """The stream rule: the daemon applies on the stream current where
    it was built, on the inner backend's card; a backend without device
    state or on the CPU needs none."""
    import torch
    for inner in (HostTreeBackend(100), DeviceTableBackend(100,
                                                           device="cpu"),
                  ShardedTableBackend(100, n_shards=2, device="cpu")):
        be = AsyncDaemonBackend(inner)
        assert be._stream is None
        be.close()
    if torch.cuda.is_available():
        be = AsyncDaemonBackend(DeviceTableBackend(100))
        assert be._stream == torch.cuda.current_stream()
        be.close()


# ------------------------- residual-transfer-exactly-once (regression)


def _cg(kind: str, pkg: str):
    if pkg == "jax":
        return JC.AgentCgroup(JK.standard_backend_factory(kind)(500, 16))
    return AgentCgroup(standard_backend_factory(kind, device="cpu")(500, 16))


def _spec(pkg: str, **kw):
    return (JC.DomainSpec if pkg == "jax" else DomainSpec)(**kw)


def _rmdir_race(cg, pkg) -> list:
    cg.mkdir("/s")
    cg.mkdir("/s/tool", _spec(pkg, high=40))
    out = [cg.try_charge("/s/tool", 30).granted]
    cg.flush()
    # in flight: still queued when rmdir is submitted (async); FIFO
    # ordering must serialize them before the removal
    cg.charge_unchecked("/s/tool", 12)
    cg.uncharge("/s/tool", 2)
    out.append(cg.rmdir("/s/tool"))
    for _ in range(2):                    # re-flushing must not re-apply
        cg.flush()
        out += [cg.exists("/s/tool"), cg.usage("/s"), cg.usage("/")]
    return out


def _kill_race(cg) -> list:
    cg.mkdir("/k")
    cg.mkdir("/k/a")
    out = [cg.try_charge("/k/a", 40).granted]
    cg.charge_unchecked("/k/a", 5)        # queued on async backends
    out.append(cg.kill("/k"))
    for _ in range(2):
        cg.flush()
        out += [cg.usage("/"), cg.try_charge("/k/a", 1).granted]
    return out


def _close(cg) -> None:
    close = getattr(cg.backend, "close", None)
    if close:
        close()


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_rmdir_racing_inflight_charges_transfers_residual_once(kind):
    """``rmdir`` racing a queued charge batch transfers the residual to
    the parent exactly once, on every backend kind, as the JAX package's
    same kind does."""
    cg = _cg(kind, "torch")
    got = _rmdir_race(cg, "torch")
    _close(cg)
    assert got == [True, 40] + [False, 40, 40] * 2
    jcg = _cg("host", "jax")              # the reference's answers
    assert got == _rmdir_race(jcg, "jax")


@pytest.mark.parametrize("kind", BACKEND_KINDS)
def test_kill_racing_inflight_charges_releases_once(kind):
    cg = _cg(kind, "torch")
    got = _kill_race(cg)
    _close(cg)
    assert got == [True, 45] + [0, False] * 2
    assert got == _kill_race(_cg("host", "jax"))


def test_concurrent_flushes_apply_exactly_once():
    """Many threads flushing while fire-and-forget charges are queued:
    every op applies once, in order."""
    cg = AgentCgroup(AsyncDaemonBackend(HostTreeBackend(500)))
    cg.mkdir("/s")
    cg.mkdir("/s/tool")
    assert cg.try_charge("/s/tool", 30).granted
    for _ in range(8):
        cg.charge_unchecked("/s/tool", 1)
    threads = [threading.Thread(target=cg.backend.flush) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert cg.rmdir("/s/tool") == 38
    assert cg.usage("/s") == 38 and cg.usage("/") == 38
    cg.backend.close()
