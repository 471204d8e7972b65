"""Unified cgroupfs-style control plane for AgentCgroup (paper §5).

Port of ``repro/core/cgroup.py``: one cgroupfs idiom over a pluggable
enforcement backend,

    cg = AgentCgroup(DeviceTableBackend(capacity))      # on the card
    cg.mkdir("/t/sess", DomainSpec(high=400, priority=HIGH))
    cg.write("/t/sess", "memory.high", 300)
    cg.try_charge("/t/sess", 64)
    cg.read("/t/sess", "memory.events")
    cg.freeze("/t/sess"); cg.thaw("/t/sess"); cg.kill("/t/sess")
    lease = cg.intent.declare("tool_7", Hint.HIGH, parent="/t/sess")
    ...; lease.feedback("throttled"); lease.close()    # residual moves up

Backends conform to the ``Backend`` protocol:

  * ``HostTreeBackend`` — wraps ``domains.DomainTree``: the reference
    semantics (trace replay, the conformance kit's golden streams), with
    memcg-style event counters surfaced through
    ``read(path, "memory.events")``.
  * ``DeviceTableBackend`` — torch state on a CUDA card (or on the CPU
    when the caller asks) with its ``DeviceView``: lifecycle host-side,
    enforcement in-step through the fused charge and gate kernels.

  * ``ShardedTableBackend`` (``core/sharded.py``) — the device table as
    ``(n_shards, n)`` tensors with per-tenant shard placement.
  * ``AsyncDaemonBackend`` (``core/daemon.py``) — wraps any of the above
    and moves every lifecycle op onto a daemon thread behind a FIFO
    queue, applied in epochs at ``flush()``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import domains as D
from repro_torch.core import pressure as P
from repro_torch.core import sched as S
from repro_torch.core.events import Ev, EventLog, OomEvent
from repro_torch.core.intent import Feedback, Hint, hint_to_high, make_feedback
from repro_torch.core.progs import (ChainView, PolicyProgram, Request,
                                    as_program, as_programs, charge_decision,
                                    check_registry, pad_row, path_in_scope,
                                    registry_unknown_params, registry_width)

UNLIMITED = D.UNLIMITED

# readable / writable control files (the cgroupfs surface);
# memory.pressure / cpu.pressure are PSI strings computed by the facade
# from the backends' raw subtree stall counters (memory.stall /
# cpu.stall — see core/pressure.py)
_READ_FILES = ("memory.current", "memory.peak", "memory.high", "memory.max",
               "memory.low", "memory.priority", "memory.events",
               "cgroup.freeze", "cpu.weight", "cpu.max",
               "memory.pressure", "cpu.pressure",
               "memory.stall", "cpu.stall")
_WRITE_FILES = ("memory.high", "memory.max", "memory.low", "memory.priority",
                "cgroup.freeze", "cpu.weight", "cpu.max")


@dataclass(frozen=True)
class DomainSpec:
    """Creation-time limits — the values seeded into the control files."""
    high: int = UNLIMITED
    max: int = UNLIMITED
    low: int = 0
    priority: int = D.NORMAL
    weight: int = D.DEFAULT_WEIGHT     # cpu.weight (1..10000)
    cpu_max: int = UNLIMITED           # cpu.max: step quota per window


@dataclass(frozen=True)
class ChargeTicket:
    """Unified result of a hierarchical charge attempt.

    ``stalled`` marks retryable denials (freeze / throttle / hard max —
    the engine's graceful-degradation path never OOM-kills in-step).
    ``blocked_by``/``over_high`` carry the host backend's detail; the
    device backend reports grants only (its detail lives in-step).
    ``delay_ms`` is the program-imposed throttle window now pending on
    the charged domain (get_high_delay_ms), 0 when none.
    """
    granted: bool
    stalled: bool = False
    blocked_by: Optional[str] = None
    over_high: tuple = ()
    delay_ms: float = 0.0


def parent_path(path: str) -> Optional[str]:
    if path == "/":
        return None
    return path.rsplit("/", 1)[0] or "/"


def ancestor_paths(path: str) -> list[str]:
    """Self-first ancestor chain, derived purely from the path string —
    identical for every backend."""
    out = [path]
    while (p := parent_path(out[-1])) is not None:
        out.append(p)
    return out


@runtime_checkable
class Backend(Protocol):
    """What a conforming enforcement substrate must provide."""

    log: EventLog
    prog: PolicyProgram

    def attach(self, scope: str, prog: PolicyProgram) -> None: ...
    def update_params(self, path: str, kv: dict) -> None: ...
    def mkdir(self, path: str, spec: DomainSpec) -> int: ...
    def rmdir(self, path: str, transfer_residual: bool) -> int: ...
    def exists(self, path: str) -> bool: ...
    def paths(self) -> list[str]: ...
    def handle(self, path: str) -> int: ...
    def path_of(self, handle: int) -> str: ...
    def try_charge(self, path: str, pages: int,
                   step: Optional[int]) -> ChargeTicket: ...
    def uncharge(self, path: str, pages: int) -> None: ...
    def charge_unchecked(self, path: str, pages: int) -> None: ...
    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list: ...
    def freeze(self, path: str) -> None: ...
    def thaw(self, path: str) -> None: ...
    def kill(self, path: str) -> int: ...
    def read(self, path: str, file: str): ...
    def write(self, path: str, file: str, value) -> None: ...
    def snapshot(self) -> dict: ...
    def set_time(self, t: float) -> None: ...


# --------------------------------------------------------------------- host


class HostTreeBackend:
    """Reference backend: the pure-Python ``DomainTree`` data model, with
    every charge *decision* dispatched into the attached
    ``PolicyProgram`` through the same ``charge_decision`` the device
    table runs — one decision path for trace replay, the conformance
    kit and the serving engine.

    The decision runs eagerly on small CPU tensors built from the tree
    for each charge.  This backend holds no device state and is the
    reference semantics the conformance kit diffs every other backend
    against; it is not a fallback of the device table, and nothing on
    the card's path reaches it (a dozen tiny launches a charge would
    time the launch latency, not the tree).

    Clock convention: ``try_charge(..., step=k)`` runs on the integer
    step clock (throttle windows quantize to ``prog.step_ms`` steps,
    matching the device table bit for bit); ``step=None`` runs on the
    facade's millisecond clock (``set_time``) as f32, with unquantized
    windows — what the trace-replay simulator uses.  Don't mix the two
    on one instance.
    """

    def __init__(self, capacity: int, log: Optional[EventLog] = None,
                 prog: Optional[PolicyProgram] = None):
        self.tree = D.DomainTree(capacity, log)
        self.log = self.tree.log
        self._ids: dict[str, int] = {"/": 0}
        self._paths: dict[int, str] = {0: "/"}
        self._next_id = 1
        self.progs = as_programs(prog)
        self.scopes = ["/"]
        self._rows: dict[str, np.ndarray] = {"/": self.prog.default_row()}
        self._pids: dict[str, int] = {"/": 0}    # path -> registry slot
        self.tree.root.flat_weight = 1.0

    # -------------------------------------------------------------- programs

    @property
    def prog(self) -> PolicyProgram:
        """The primary (slot 0) program — registry constants and the
        single-program surface."""
        return self.progs[0]

    @property
    def attach_scope(self) -> str:
        return self.scopes[0]

    def attach(self, scope: str, prog: PolicyProgram) -> None:
        """Root attach resets the registry to this one program (every
        domain on its default row).  A subtree attach composes: the
        program takes a registry slot, in-scope domains move to it;
        everything outside keeps its current program and live rows."""
        prog = as_program(prog)
        if scope == "/":
            self.progs = (prog,)
            self.scopes = ["/"]
            self._rows = {p: prog.default_row() for p in self.tree._index}
            self._pids = {p: 0 for p in self.tree._index}
            return
        if scope in self.scopes:
            k = self.scopes.index(scope)
            self.progs = self.progs[:k] + (prog,) + self.progs[k + 1:]
        else:
            k = len(self.progs)
            self.progs = self.progs + (prog,)
            self.scopes.append(scope)
        check_registry(self.progs)
        width = registry_width(self.progs)
        for p in self.tree._index:
            if path_in_scope(scope, p):
                self._pids[p] = k
                self._rows[p] = pad_row(prog.default_row(), width)
            else:
                self._rows[p] = pad_row(self._rows[p], width)

    def update_params(self, path: str, kv: dict) -> None:
        unknown = registry_unknown_params(self.progs, kv)
        if unknown:
            raise KeyError(
                f"no registered program has param(s) {sorted(unknown)}")
        for p in self.tree._index:
            if path_in_scope(path, p):
                pr = self.progs[self._pids[p]]
                for k, v in kv.items():
                    if k in pr.param_names:
                        self._rows[p][pr.col(k)] = float(v)

    def _recompute_flat(self) -> None:
        """Re-flatten hierarchical weights (lifecycle rate: mkdir /
        rmdir / cpu.weight writes), scx_flatcg style."""
        flat = S.flat_weights_by_path(
            {p: d.weight for p, d in self.tree._index.items()})
        for p, d in self.tree._index.items():
            d.flat_weight = float(flat[p])

    # lifecycle
    def mkdir(self, path: str, spec: DomainSpec) -> int:
        self.tree.create(path, high=spec.high, max=spec.max, low=spec.low,
                         priority=spec.priority, weight=spec.weight,
                         cpu_max=spec.cpu_max)
        h = self._next_id
        self._next_id += 1
        self._ids[path] = h
        self._paths[h] = path
        parent = parent_path(path)
        # children inherit the parent's live row AND program slot
        self._rows[path] = self._rows[parent].copy()
        self._pids[path] = self._pids[parent]
        self._recompute_flat()
        return h

    def rmdir(self, path: str, transfer_residual: bool) -> int:
        residual = self.tree.get(path).usage
        parent = parent_path(path)
        self.tree.remove(path)           # uncharges residual from the chain
        if transfer_residual and residual and parent is not None:
            self.charge_unchecked(parent, residual)
        self._paths.pop(self._ids.pop(path), None)
        self._rows.pop(path, None)
        self._pids.pop(path, None)
        self._recompute_flat()
        return residual

    def exists(self, path: str) -> bool:
        return self.tree.exists(path)

    def paths(self) -> list[str]:
        return list(self.tree._index)

    def handle(self, path: str) -> int:
        return self._ids[path]

    def path_of(self, handle: int) -> str:
        return self._paths[handle]

    # charging
    def try_charge(self, path: str, pages: int,
                   step: Optional[int]) -> ChargeTicket:
        d = self.tree.get(path)
        step_mode = step is not None
        clock = step if step_mode else self.tree.now_ms
        chain = list(d.ancestors())

        def i32(values):
            return torch.tensor(values, dtype=torch.int32)

        view = ChainView(
            valid=torch.ones((len(chain),), dtype=torch.bool),
            usage=i32([a.usage for a in chain]),
            high=i32([a.high for a in chain]),
            max=i32([a.max for a in chain]),
            low=i32([a.low for a in chain]),
            frozen=torch.tensor([a.frozen or a.killed for a in chain]),
            throttle_until=torch.tensor([a.throttle_until for a in chain],
                                        dtype=torch.float32),
            priority=i32(d.priority),
            params=torch.from_numpy(
                np.asarray(self._rows[path], np.float32)),
            prog_id=i32(self._pids[path]),
        )
        req = Request(i32(self._ids[path] % (1 << 30)), i32(pages),
                      i32(clock) if step_mode
                      else torch.tensor(clock, dtype=torch.float32))
        verdict, delay_ms, throttle = charge_decision(self.progs, view, req)
        self._rows[path] = verdict.params.numpy().copy()
        # PSI accounting — the event formula charge_batch applies on the
        # device: a stalled or throttled decision stalls the domain
        # (saturating at INT32_MAX like the tensor counters)
        if bool(verdict.stall) or bool(throttle):
            d.mem_stall = min(d.mem_stall + 1, P.INT32_MAX)

        # ``delay_ms`` on the ticket = the throttle window now pending on
        # the charged domain, in ms — the device table's convention
        # (quantized on the step clock, exact on the ms clock)
        def window() -> float:
            w = max(0.0, d.throttle_until - clock)
            return w * self.prog.step_ms if step_mode else w

        if not bool(verdict.grant):
            if d.frozen or d.killed:
                return ChargeTicket(False, True, blocked_by=path,
                                    delay_ms=window())
            blk = self.tree.blocking_ancestor(d, pages)
            if blk is not None:           # hard-max denial: memcg counters
                self.tree.note_max_breach(blk, pages)
                return ChargeTicket(False, True, blocked_by=blk.name,
                                    delay_ms=window())
            # active throttle window or program admission (token bucket)
            return ChargeTicket(False, True, blocked_by=path,
                                delay_ms=window())

        over = self.tree.commit_charge(d, pages)
        dly_ms = float(delay_ms)
        if bool(throttle) and dly_ms > 0:
            if step_mode:                 # quantized, like the device table
                deadline = clock + int(np.ceil(
                    np.float32(dly_ms) / np.float32(self.prog.step_ms)))
            else:
                deadline = clock + dly_ms
            d.throttle_until = max(d.throttle_until, deadline)
            d.n_throttle += 1
            self.log.emit(self.tree.now_ms, Ev.THROTTLE, path,
                          delay_ms=dly_ms)
        return ChargeTicket(True, False, over_high=over,
                            delay_ms=window())

    def uncharge(self, path: str, pages: int) -> None:
        self.tree.uncharge(path, pages)

    def charge_unchecked(self, path: str, pages: int) -> None:
        """Bookkeeping charge for lifecycle moves (residual transfer,
        thaw re-charge): the pages are already resident, never denied."""
        for a in self.tree.get(path).ancestors():
            a.usage = max(0, a.usage + pages)
            a.peak = max(a.peak, a.usage)

    # scheduling (the sched_ext half)
    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list:
        """One weighted scheduling round over the given slots — the same
        ``schedule_decision`` the device table runs, on a state view
        assembled from the tree."""
        order = list(self.tree._index)
        row = {p: i for i, p in enumerate(order)}
        doms = [self.tree.get(p) for p in order]

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype)

        i32, f32 = torch.int32, torch.float32
        state = {
            "usage": col([d.usage for d in doms], i32),
            "high": col([d.high for d in doms], i32),
            "max": col([d.max for d in doms], i32),
            "low": col([d.low for d in doms], i32),
            "parent": col([row.get(parent_path(p), -1) if p != "/" else -1
                           for p in order], i32),
            "priority": col([d.priority for d in doms], i32),
            "frozen": col([d.frozen or d.killed for d in doms], torch.bool),
            "active": torch.ones((len(order),), dtype=torch.bool),
            "throttle_until": col([d.throttle_until for d in doms], f32),
            "prog": torch.from_numpy(np.stack(
                [np.asarray(self._rows[p], np.float32) for p in order])),
            "weight": col([d.weight for d in doms], i32),
            "cpu_max": col([d.cpu_max for d in doms], i32),
            "flat_weight": col([d.flat_weight for d in doms], f32),
            "vruntime": col([d.vruntime for d in doms], f32),
            "cpu_used": col([d.cpu_used for d in doms], i32),
            "cpu_stamp": col([d.cpu_stamp for d in doms], i32),
            "cpu_stall": col([d.cpu_stall for d in doms], i32),
            "prog_id": col([self._pids[p] for p in order], i32),
        }
        dom = col([row[p] for p in paths], i32)
        cost = col(list(costs), i32)
        st, advance = S.schedule_decision(self.progs, state, dom, cost,
                                          int(step), int(budget))
        vr = st["vruntime"].tolist()
        used = st["cpu_used"].tolist()
        stamp = st["cpu_stamp"].tolist()
        stall = st["cpu_stall"].tolist()
        for i, d in enumerate(doms):
            d.vruntime = float(vr[i])
            d.cpu_used = int(used[i])
            d.cpu_stamp = int(stamp[i])
            d.cpu_stall = int(stall[i])
        return [bool(a) for a in advance.tolist()]

    # subtree control
    def freeze(self, path: str) -> None:
        self.tree.freeze(path)

    def thaw(self, path: str) -> None:
        self.tree.thaw(path)

    def kill(self, path: str) -> int:
        return self.tree.kill(path)

    # control files
    _FILE_ATTR = {"memory.current": "usage", "memory.peak": "peak",
                  "memory.high": "high", "memory.max": "max",
                  "memory.low": "low", "memory.priority": "priority",
                  "cpu.weight": "weight", "cpu.max": "cpu_max"}

    def read(self, path: str, file: str):
        d = self.tree.get(path)
        if file in self._FILE_ATTR:
            return getattr(d, self._FILE_ATTR[file])
        if file == "cgroup.freeze":
            return int(d.frozen)
        if file == "memory.events":
            return {"high": d.n_high_breach, "max": d.n_max_breach,
                    "throttle": d.n_throttle, "oom_kill": d.n_oom_kill}
        if file in P.STALL_FILES:
            attr = "mem_stall" if file == "memory.stall" else "cpu_stall"
            return P.subtree_counts_by_path(
                {n.name: getattr(n, attr)
                 for n in self.tree.subtree(path)})[path]
        raise KeyError(file)

    def write(self, path: str, file: str, value) -> None:
        d = self.tree.get(path)
        if file == "cgroup.freeze":
            (self.freeze if int(value) else self.thaw)(path)
        elif file == "cpu.weight":
            d.weight = S.check_weight(value)
            self._recompute_flat()
        elif file in self._FILE_ATTR and file not in ("memory.current",
                                                      "memory.peak"):
            setattr(d, self._FILE_ATTR[file], int(value))
        else:
            raise KeyError(file)

    def throttle_delay_ms(self, path: str, **kw) -> float:
        return self.tree.throttle_delay_ms(path, **kw)

    def snapshot(self) -> dict:
        idx = self.tree._index
        order = list(idx)
        prow = {p: i for i, p in enumerate(order)}

        def col(attr, dtype=np.int64):
            return np.array([getattr(idx[p], attr) for p in order], dtype)

        return {"paths": order, "index": prow, "usage": col("usage"),
                "high": col("high"), "max": col("max"),
                "parent": np.array([prow.get(parent_path(p), -1)
                                    if p != "/" else -1 for p in order],
                                   np.int64),
                "active": np.ones(len(order), bool),
                "params": np.stack([self._rows[p] for p in order]),
                "peak": col("peak"), "low": col("low"),
                "priority": col("priority"), "frozen": col("frozen", bool),
                "killed": col("killed", bool),
                "throttle_until": np.array([idx[p].throttle_until
                                            for p in order]),
                "weight": col("weight"), "cpu_max": col("cpu_max"),
                "vruntime": col("vruntime", np.float32),
                "cpu_used": col("cpu_used"), "cpu_stamp": col("cpu_stamp"),
                "mem_stall": col("mem_stall"), "cpu_stall": col("cpu_stall"),
                "prog_id": np.array([self._pids[p] for p in order],
                                    np.int64),
                "root_usage": self.tree.root.usage}

    def restore(self, snap: dict) -> None:
        """Rebuild the full control state from a ``snapshot()`` dict —
        the crash-recovery path.  Call after ``attach`` (parameter rows
        are restored verbatim from the snapshot, overwriting attach's
        defaults)."""
        idx = snap["index"]
        zeros = np.zeros(len(snap["paths"]), bool)
        killed = snap.get("killed", zeros)
        frozen = snap.get("frozen", zeros)
        for p in snap["paths"]:           # parents precede children
            if p != "/" and not self.tree.exists(p):
                self.mkdir(p, DomainSpec())
            d = self.tree.root if p == "/" else self.tree.get(p)
            i = idx[p]
            d.high = int(snap["high"][i])
            d.max = int(snap["max"][i])
            d.usage = int(snap["usage"][i])
            d.throttle_until = float(snap["throttle_until"][i])
            d.frozen = bool(frozen[i])
            d.killed = bool(killed[i])
            if "peak" in snap:
                d.peak = int(snap["peak"][i])
                d.low = int(snap["low"][i])
                d.priority = int(snap["priority"][i])
            if "weight" in snap:
                d.weight = int(snap["weight"][i])
                d.cpu_max = int(snap["cpu_max"][i])
                d.vruntime = float(snap["vruntime"][i])
                d.cpu_used = int(snap["cpu_used"][i])
                d.cpu_stamp = int(snap["cpu_stamp"][i])
            if "mem_stall" in snap:       # older snapshots: counters stay 0
                d.mem_stall = int(snap["mem_stall"][i])
                d.cpu_stall = int(snap["cpu_stall"][i])
            self._rows[p] = np.asarray(snap["params"][i]).copy()
            pid = snap.get("prog_id")
            self._pids[p] = int(pid[i]) if pid is not None else 0
        self._recompute_flat()

    def set_time(self, t: float) -> None:
        self.tree.now_ms = t


# ------------------------------------------------------------------- device


def _np(t) -> np.ndarray:
    """A host copy of a state tensor (never a view that a later in-place
    lifecycle edit could change)."""
    return t.detach().cpu().numpy().copy()


class DeviceView:
    """The in-step slice of the device backend: the live state dict plus
    the enforcement functions the engine's step calls — in-step
    enforcement stays on the device while everything stateful goes
    through the facade."""

    def __init__(self, backend: "DeviceTableBackend"):
        self._backend = backend
        self.cfg = backend.table.cfg

    @property
    def state(self) -> dict:
        return self._backend.table.state

    @property
    def prog(self) -> PolicyProgram:
        """The primary attached program."""
        return self._backend.table.prog

    @property
    def progs(self) -> tuple:
        """The full program registry."""
        return self._backend.table.progs

    def charge(self, state, dom, amt, step):
        """In-step hierarchical charge: (state, granted, stalled) —
        dispatched into each domain's registered program (the fused
        charge kernel on CUDA)."""
        return C.charge_batch(state, dom, amt, step, self.progs)

    def account(self, state, dom, amt):
        """Post-hoc unconditional charge (the user-space baseline:
        usage recorded after the stale gate already decided)."""
        return C.uncharge_batch(state, dom, -amt)

    def uncharge(self, state, dom, amt):
        return C.uncharge_batch(state, dom, amt)

    def gate(self, state, dom, step):
        """Per-slot advance gate (the program's ``on_gate``; the fused
        gate kernel on CUDA)."""
        return C.slot_gate(state, dom, step, self.progs)

    def schedule(self, state, dom, cost, step, budget):
        """Weighted per-slot scheduling round: (state, advance)."""
        return S.schedule_decision(self.progs, state, dom, cost, step,
                                   budget)

    def commit(self, state: dict) -> None:
        """Adopt the post-step state."""
        self._backend.table.state = state


class DeviceTableBackend:
    """Device-resident backend: lifecycle host-side, enforcement in-step.

    Wraps ``controller.DeviceDomainTable`` on ``device`` (a CUDA card
    unless the caller asks for the CPU).  ``try_charge`` here is the
    host-driven path (lifecycle, replay, cross-validation); the serving
    engine charges inside its step through ``device_view()`` instead.
    """

    def __init__(self, capacity: int, n_domains: int = 64, cfg=None,
                 log: Optional[EventLog] = None,
                 prog: Optional[PolicyProgram] = None, device="cuda"):
        self.device = C.resolve_device(device)
        self.table = C.DeviceDomainTable(capacity, n_domains,
                                         cfg or C.ControllerConfig(), prog,
                                         self.device)
        self.log = log if log is not None else EventLog()
        self._now = 0.0

    @property
    def n_domains(self) -> int:
        return self.table.n

    @property
    def prog(self) -> PolicyProgram:
        return self.table.prog

    @property
    def progs(self) -> tuple:
        return self.table.progs

    def attach(self, scope: str, prog: PolicyProgram) -> None:
        self.table.attach(scope, prog)

    def update_params(self, path: str, kv: dict) -> None:
        self.table.update_params(self._subtree(path), kv)

    def device_view(self) -> DeviceView:
        return DeviceView(self)

    def _i32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _recompute_flat(self) -> None:
        """Re-flatten hierarchical weights into the device row
        (lifecycle rate), scx_flatcg style."""
        w = self.table.state["weight"].cpu().tolist()
        flat = S.flat_weights_by_path(
            {p: int(w[i]) for p, i in self.table.index.items()})
        arr = np.zeros((self.table.n,), np.float32)
        for p, i in self.table.index.items():
            arr[i] = flat[p]
        self.table.state["flat_weight"] = torch.as_tensor(
            arr, device=self.device)

    # lifecycle
    def mkdir(self, path: str, spec: DomainSpec) -> int:
        if len(ancestor_paths(path)) > C.DEPTH:
            raise ValueError(f"{path}: deeper than DEPTH={C.DEPTH}")
        idx = self.table.create(path, high=spec.high, max=spec.max,
                                low=spec.low, priority=spec.priority,
                                weight=spec.weight, cpu_max=spec.cpu_max)
        self._recompute_flat()
        self.log.emit(self._now, Ev.CREATE, path, high=spec.high,
                      max=spec.max)
        return idx

    def rmdir(self, path: str, transfer_residual: bool) -> int:
        residual = self.table.usage(path)
        parent = parent_path(path)
        self.table.remove(path)          # uncharges residual from the chain
        if transfer_residual and residual and parent is not None:
            self.charge_unchecked(parent, residual)
        self._recompute_flat()
        self.log.emit(self._now, Ev.REMOVE, path)
        return residual

    def exists(self, path: str) -> bool:
        return path in self.table.index

    def paths(self) -> list[str]:
        return list(self.table.index)

    def handle(self, path: str) -> int:
        return self.table.index[path]

    def path_of(self, handle: int) -> str:
        for p, i in self.table.index.items():
            if i == handle:
                return p
        raise KeyError(handle)

    # charging (host-driven path)
    def try_charge(self, path: str, pages: int,
                   step: Optional[int]) -> ChargeTicket:
        if step is None:
            # honor the facade clock so earlier throttles expire
            step = int(self._now)
        idx = self.table.index[path]
        st, granted, stalled = C.charge_batch(
            self.table.state, self._i32([idx]), self._i32([pages]), step,
            self.table.progs)
        self.table.state = st
        window = max(0, int(st["throttle_until"][idx]) - step)
        return ChargeTicket(granted=bool(granted[0]),
                            stalled=bool(stalled[0]),
                            delay_ms=window * self.table.prog.step_ms)

    def uncharge(self, path: str, pages: int) -> None:
        idx = self.table.index[path]
        self.table.state = C.uncharge_batch(
            self.table.state, self._i32([idx]), self._i32([pages]))

    def charge_unchecked(self, path: str, pages: int) -> None:
        self.table.state = C.host_charge(self.table.state,
                                         self.table.index[path], pages)

    # scheduling (host-driven path; the engine schedules in-step via
    # device_view().schedule)
    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list:
        dom = self._i32([self.table.index[p] for p in paths])
        st, advance = S.schedule_decision(
            self.table.progs, self.table.state, dom, self._i32(list(costs)),
            int(step), int(budget))
        self.table.state = st
        return [bool(a) for a in advance.cpu().tolist()]

    # subtree control
    def _subtree(self, path: str) -> list[str]:
        return [p for p in self.table.index if path_in_scope(path, p)]

    def freeze(self, path: str) -> None:
        for p in self._subtree(path):
            self.table.set_frozen(p, True)
        self.log.emit(self._now, Ev.FREEZE, path)

    def thaw(self, path: str) -> None:
        for p in self._subtree(path):
            self.table.set_frozen(p, False)
        self.log.emit(self._now, Ev.THAW, path)

    def kill(self, path: str) -> int:
        """Atomic subtree kill: release the subtree root's hierarchical
        usage from its chain, then retire every node in place.  Killed
        domains stay registered and deny further charges through the
        frozen flag, the device state's only in-step deny bit."""
        freed = self.table.usage(path)
        if freed:
            self.uncharge(path, freed)
        st = self.table.state
        for p in self._subtree(path):
            idx = self.table.index[p]
            st["usage"][idx] = 0
            st["active"][idx] = False
            st["frozen"][idx] = True
        self.log.emit(self._now, Ev.OOM_KILL, path, freed=freed)
        return freed

    # control files
    _FILE_KEY = {"memory.current": "usage", "memory.peak": "peak",
                 "memory.high": "high", "memory.max": "max",
                 "memory.low": "low", "memory.priority": "priority",
                 "cgroup.freeze": "frozen", "cpu.weight": "weight",
                 "cpu.max": "cpu_max"}

    def read(self, path: str, file: str):
        if file == "memory.events":
            # device counters live in-step; only throttle state is
            # observable host-side
            idx = self.table.index[path]
            return {"high": 0, "max": 0,
                    "throttle": int(int(
                        self.table.state["throttle_until"][idx]) > 0),
                    "oom_kill": 0}
        if file in P.STALL_FILES:
            key = "mem_stall" if file == "memory.stall" else "cpu_stall"
            col = self.table.state[key].cpu().tolist()
            return P.subtree_counts_by_path(
                {p: int(col[i]) for p, i in self.table.index.items()
                 if path_in_scope(path, p)})[path]
        idx = self.table.index[path]
        return int(self.table.state[self._FILE_KEY[file]][idx])

    def write(self, path: str, file: str, value) -> None:
        if file == "cgroup.freeze":
            (self.freeze if int(value) else self.thaw)(path)
            return
        if file == "cpu.weight":
            value = S.check_weight(value)
        idx = self.table.index[path]
        self.table.state[self._FILE_KEY[file]][idx] = int(value)
        if file == "cpu.weight":
            self._recompute_flat()

    def snapshot(self) -> dict:
        st = self.table.state
        snap = {"paths": list(self.table.index),
                "index": dict(self.table.index)}
        for key, src in _SNAPSHOT_KEYS:
            snap[key] = _np(st[src])
        snap["root_usage"] = int(st["usage"][0])
        return snap

    def restore(self, snap: dict) -> None:
        """Rebuild index + device state from a ``snapshot()`` dict — the
        crash-recovery path.  Call on a freshly constructed backend of
        the same ``n_domains``, after ``attach``."""
        t = self.table
        if len(snap["usage"]) != t.n:
            raise ValueError("snapshot/table shape mismatch")
        t.index = dict(snap["index"])
        used = set(t.index.values())
        t._free = [i for i in range(1, t.n) if i not in used]
        heapq.heapify(t._free)
        st = dict(t.state)
        for key, src in _SNAPSHOT_KEYS:
            if key in snap:
                st[src] = torch.as_tensor(np.asarray(snap[key]),
                                          dtype=st[src].dtype,
                                          device=self.device).clone()
        t.state = st
        if "flat_weight" not in snap:      # older snapshot: re-flatten
            self._recompute_flat()

    def set_time(self, t: float) -> None:
        self._now = t


# snapshot key -> control-state key (the reference's snapshot layout)
_SNAPSHOT_KEYS = (
    ("usage", "usage"), ("high", "high"), ("max", "max"),
    ("parent", "parent"), ("active", "active"), ("peak", "peak"),
    ("low", "low"), ("priority", "priority"), ("frozen", "frozen"),
    ("throttle_until", "throttle_until"), ("params", "prog"),
    ("weight", "weight"), ("cpu_max", "cpu_max"),
    ("flat_weight", "flat_weight"), ("vruntime", "vruntime"),
    ("cpu_used", "cpu_used"), ("cpu_stamp", "cpu_stamp"),
    ("mem_stall", "mem_stall"), ("cpu_stall", "cpu_stall"),
    ("prog_id", "prog_id"))


# ----------------------------------------------------------- intent channel


@dataclass
class Lease:
    """A declared tool-call scope: an ephemeral child domain whose
    ``memory.high`` came from the upward intent hint.  Closing the lease
    removes the domain and moves retained pages up to the parent
    (retry/context accumulation — the paper's residual-transfer rule).

    ``attempt`` counts re-declarations of the same tool call by the
    escalation loop; a kill on the lease's domain marks it ``killed``
    and attaches the typed ``OomEvent`` (semantic OOM feedback)."""
    channel: "IntentChannel"
    tool_id: str
    path: str
    parent: str
    hint: Optional[Hint]
    high: int
    priority: int = D.NORMAL
    max: int = UNLIMITED
    attempt: int = 1
    closed: bool = False
    killed: bool = False
    oom: Optional[OomEvent] = None

    def feedback(self, reason: str, peak: Optional[int] = None,
                 limit: Optional[int] = None) -> Feedback:
        return self.channel.feedback(self.path, reason, peak=peak,
                                     limit=limit)

    def close(self, *, transfer_residual: bool = True) -> int:
        """rmdir the tool domain; returns the residual moved upward.

        The residual transfer is bookkeeping (``charge_unchecked``) —
        the pages are already resident, so unlike a fresh ``try_charge``
        it is never denied and counts no breach events.  The DONE event
        (with ``memory.peak``) lands in the backend's log; on the
        device backend that read costs one host sync, at lifecycle
        rate, not step rate.  A killed lease emits no DONE — the kill
        already emitted OOM_KILL + OOM; close() only reclaims the
        (empty) domain so the tool id can be re-declared."""
        if self.closed:
            return 0
        self.closed = True
        self.channel._open.pop(self.path, None)
        cg = self.channel.cg
        if not cg.exists(self.path):
            return 0
        if not self.killed:
            cg.log.emit(cg.now, Ev.DONE, self.path,
                        peak=cg.read(self.path, "memory.peak"))
        return cg.rmdir(self.path, transfer_residual=transfer_residual)


class IntentChannel:
    """Bidirectional intent coordination bound to one ``AgentCgroup``.

    Upward: ``declare(tool_id, hint)`` opens a per-tool-call child
    domain whose ``memory.high`` derives from the hint (mis-declared
    calls throttle early instead of starving siblings).  Downward:
    ``feedback`` emits the structured record an adaptive agent uses to
    reconstruct its strategy, and any ``kill()`` that lands on an open
    lease produces a typed ``OomEvent`` delivered to the owning session
    (``oom_events``) — the exit-137 -> stderr loop of the paper's §6
    wrapper, made structural.
    """

    def __init__(self, cg: "AgentCgroup"):
        self.cg = cg
        self.n_declared = 0
        self.n_feedbacks = 0
        self._open: dict[str, Lease] = {}        # path -> live lease
        self._oom: dict[str, list] = {}          # session -> [OomEvent]

    def declare(self, tool_id: str, hint: Optional[Hint] = None, *,
                parent: str = "/", priority: int = D.NORMAL,
                high: Optional[int] = None, max: int = UNLIMITED,
                attempt: int = 1) -> Lease:
        if high is None:
            high = hint_to_high(hint)
        path = f"{parent.rstrip('/')}/{tool_id}"
        self.cg.mkdir(path, DomainSpec(high=high, max=max, priority=priority))
        self.n_declared += 1
        lease = Lease(self, tool_id, path, parent, hint, high,
                      priority=priority, max=max, attempt=attempt)
        self._open[path] = lease
        return lease

    def open_leases(self, under: str = "/") -> list[Lease]:
        return [ls for p, ls in self._open.items()
                if path_in_scope(under, p)]

    def feedback(self, path: str, reason: str, *, peak: Optional[int] = None,
                 limit: Optional[int] = None) -> Feedback:
        if peak is None and self.cg.exists(path):
            peak = self.cg.read(path, "memory.peak")
        if limit is None and self.cg.exists(path):
            limit = self.cg.read(path, "memory.high")
            if limit >= UNLIMITED:
                limit = self.cg.read(path, "memory.max")
        fb = make_feedback(path, reason,
                           peak if peak is not None else 0,
                           limit if limit is not None else 0)
        self.n_feedbacks += 1
        self.cg.log.emit(self.cg.now, Ev.FEEDBACK, path, reason=reason)
        return fb

    # ------------------------------------------------- semantic OOM events

    def _pre_kill(self, path: str) -> list[tuple]:
        """Capture (lease, peak, limit, residual) for every open lease
        under ``path`` BEFORE the backend kill zeroes usage."""
        pre = []
        for lease in self.open_leases(path):
            if lease.killed or not self.cg.exists(lease.path):
                continue
            peak = self.cg.read(lease.path, "memory.peak")
            limit = self.cg.read(lease.path, "memory.max")
            if limit >= UNLIMITED:
                limit = self.cg.read(lease.path, "memory.high")
            pre.append((lease, peak, limit, self.cg.usage(lease.path)))
        return pre

    def _post_kill(self, pre: list[tuple]) -> None:
        """Mark the leases killed and deliver typed OomEvents to their
        owning sessions (the lease parent)."""
        for lease, peak, limit, residual in pre:
            ev = OomEvent(path=lease.path, session=lease.parent,
                          peak_pages=int(peak), limit_pages=int(limit),
                          attempt=lease.attempt,
                          residual_pages=int(residual), t_ms=self.cg.now)
            lease.killed = True
            lease.oom = ev
            self._oom.setdefault(lease.parent, []).append(ev)
            self.cg.log.emit(self.cg.now, Ev.OOM, lease.path,
                             session=lease.parent, peak=ev.peak_pages,
                             limit=ev.limit_pages, attempt=ev.attempt,
                             residual=ev.residual_pages)

    def note_external_kill(self, path: str, freed: int = 0) -> None:
        """Record a kill that bypassed the facade (fault injection, a
        backend-side OOM): synthesize the same OomEvents an in-band
        ``AgentCgroup.kill`` would have delivered.  Peak/limit are read
        after the fact (both survive the kill on every backend); usage
        is already zeroed, so the caller supplies ``freed`` as the
        residual when a single lease was hit."""
        pre = self._pre_kill(path)
        if len(pre) == 1 and freed:
            lease, peak, limit, _ = pre[0]
            pre = [(lease, peak, limit, freed)]
        self._post_kill(pre)

    def oom_events(self, session: str, *, clear: bool = False) -> list:
        """Typed OomEvents delivered to ``session`` (oldest first)."""
        evs = self._oom.get(session, [])
        if clear:
            self._oom[session] = []
        return list(evs)


# -------------------------------------------------------------------- facade


class AgentCgroup:
    """The unified control plane: cgroupfs-style files + intent channel
    over a pluggable enforcement backend."""

    def __init__(self, backend: Backend):
        self.backend = backend
        self.intent = IntentChannel(self)
        self._now = 0.0
        # PSI averaging over the backends' raw stall counters; decay
        # runs on the facade clock (set_time) — one meter per facade,
        # so identical op sequences render identical pressure strings
        # on every backend kind
        self._pressure = P.PressureMeter()

    # ------------------------------------------------------------ lifecycle

    def mkdir(self, path: str, spec: Optional[DomainSpec] = None, **kw) -> int:
        """Create a domain; returns the backend handle (slot index)."""
        if not path.startswith("/") or path == "/":
            raise ValueError(f"not a creatable domain path: {path!r}")
        spec = spec if spec is not None else DomainSpec(**kw)
        parent = parent_path(path)
        if not self.backend.exists(parent):
            raise FileNotFoundError(f"parent {parent!r} of {path!r}")
        return self.backend.mkdir(path, spec)

    def rmdir(self, path: str, *, transfer_residual: bool = True) -> int:
        """Remove a leaf domain.  By default residual charges transfer
        to the parent (pages outliving the tool call stay accounted to
        the session); with ``transfer_residual=False`` they release."""
        self._pressure.forget(path)
        return self.backend.rmdir(path, transfer_residual)

    def exists(self, path: str) -> bool:
        return self.backend.exists(path)

    def paths(self) -> list[str]:
        return self.backend.paths()

    def handle(self, path: str) -> int:
        return self.backend.handle(path)

    def path_of(self, handle: int) -> str:
        return self.backend.path_of(handle)

    # ------------------------------------------------------------- programs

    @property
    def program(self) -> PolicyProgram:
        """The primary attached enforcement program (memcg_bpf_ops
        analogue) — registry slot 0."""
        return self.backend.prog

    @property
    def programs(self) -> tuple:
        """The full program registry: slot 0 is the primary; subtree
        attaches append further slots, selected per domain by the
        ``prog_id`` control-state column."""
        return tuple(getattr(self.backend, "progs", (self.backend.prog,)))

    def attach(self, path: str, prog: PolicyProgram) -> None:
        """Attach a ``PolicyProgram`` to the subtree at ``path`` — the
        BPF-attach analogue.  A root attach (``path="/"``) resets the
        registry to this one program.  A subtree attach COMPOSES: the
        program takes a registry slot and only in-scope domains dispatch
        into it (via their ``prog_id``), so different tenants run truly
        different enforcement code; domains outside the subtree keep
        their current program and live parameters (the memcg contract
        still applies to them).  Jitted consumers must re-trace
        (``Engine.attach_program`` does).
        """
        if path != "/" and not self.backend.exists(path):
            raise FileNotFoundError(path)
        self.backend.attach(path, prog)

    def update_params(self, path: str, **kv) -> None:
        """Retune the live program for the subtree at ``path`` — a BPF
        map write: pure state, takes effect next charge.  Each domain resolves keys through its own program;
        keys unknown to every registered program raise ``KeyError``.
        """
        self.backend.update_params(path, kv)

    # --------------------------------------------------------- control files

    def read(self, path: str, file: str):
        if file not in _READ_FILES:
            raise KeyError(file)
        if file in P.PRESSURE_FILES:
            total = int(self.backend.read(path, P.STALL_OF[file]))
            if self._pressure.auto_step:    # ms clock: track the program
                self._pressure.step_ms = float(self.backend.prog.step_ms)
            return self._pressure.read(path, file, total, self._now)
        return self.backend.read(path, file)

    def write(self, path: str, file: str, value) -> None:
        if file not in _WRITE_FILES:
            raise KeyError(file)
        self.backend.write(path, file, value)

    def pressure_clock(self, *, step_quantum: Optional[float] = None,
                       windows: Optional[tuple] = None) -> None:
        """Reconfigure the PSI meter: a caller whose ``set_time`` counts
        steps instead of ms (the serving engine) passes
        ``step_quantum=1.0`` and the decay windows converted to steps;
        ``windows`` alone shortens the averaging horizon (tests,
        fast-reacting controllers) while keeping the ms clock."""
        if step_quantum is not None:
            self._pressure.auto_step = False
            self._pressure.step_ms = float(step_quantum)
        if windows is not None:
            self._pressure.windows = (float(windows[0]), float(windows[1]))

    # -------------------------------------------------------------- charging

    def try_charge(self, path: Union[str, int], pages: int,
                   step: Optional[int] = None) -> ChargeTicket:
        """Hierarchical memcg charge.  ``step`` is the device backend's
        throttle clock; when omitted it falls back to the facade clock
        (``set_time``), so host-driven throttles expire with time."""
        if isinstance(path, int):
            path = self.path_of(path)
        return self.backend.try_charge(path, pages, step)

    def uncharge(self, path: Union[str, int], pages: int) -> None:
        if isinstance(path, int):
            path = self.path_of(path)
        self.backend.uncharge(path, pages)

    def charge_unchecked(self, path: Union[str, int], pages: int) -> None:
        """Lifecycle bookkeeping charge (residual transfer, thaw
        re-charge): the pages are already resident, never denied."""
        if isinstance(path, int):
            path = self.path_of(path)
        self.backend.charge_unchecked(path, pages)

    # ------------------------------------------------------------ scheduling

    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list:
        """One weighted scheduling round (the sched_ext half): slot
        ``i`` runs in domain ``paths[i]`` at step cost ``costs[i]``;
        ``budget`` is the total cost grantable to weighted slots this
        step.  Returns per-slot advance booleans and updates the
        domains' vruntime / cpu.max window accounts.  With the default
        program every runnable slot advances (the old binary gate);
        attach ``WeightedFairProgram`` for cpu.weight-proportional
        sharing."""
        if len(paths) != len(costs):
            raise ValueError("one cost per slot path")
        return self.backend.schedule(paths, costs, step, budget)

    # ------------------------------------------------------ subtree control

    def freeze(self, path: str) -> None:
        self.backend.freeze(path)

    def thaw(self, path: str) -> None:
        self.backend.thaw(path)

    def kill(self, path: str) -> int:
        """memory.oom.group analogue.  Any open lease inside the killed
        subtree additionally yields a typed ``OomEvent`` delivered to
        its owning session (semantic OOM feedback, paper §5/§6)."""
        pre = self.intent._pre_kill(path)
        freed = self.backend.kill(path)
        self.intent._post_kill(pre)
        return freed

    # -------------------------------------------------------------- queries

    def usage(self, path: str = "/") -> int:
        return int(self.read(path, "memory.current"))

    def peak(self, path: str = "/") -> int:
        return int(self.read(path, "memory.peak"))

    @property
    def capacity(self) -> int:
        return int(self.read("/", "memory.max"))

    def free(self) -> int:
        return self.capacity - self.usage("/")

    def throttle_delay_ms(self, path: str, **kw) -> float:
        fn = getattr(self.backend, "throttle_delay_ms", None)
        if fn is None:
            raise NotImplementedError(
                "device throttling is computed in-step; use device_view()")
        return fn(path, **kw)

    def snapshot(self) -> dict:
        """Telemetry arrays for host-side daemons (one device sync).

        Row order is backend-specific: the device backend's rows are
        addressable by ``handle()`` (the slot index); for
        backend-agnostic lookup use ``snapshot()['index'][path]``.
        """
        return self.backend.snapshot()

    def restore(self, snap: dict) -> None:
        """Rebuild backend control state from a ``snapshot()`` dict —
        crash recovery onto a freshly constructed backend of the same
        kind (see ``HostTreeBackend.restore``)."""
        self.backend.restore(snap)

    # ----------------------------------------------------------- device path

    def device_view(self) -> DeviceView:
        fn = getattr(self.backend, "device_view", None)
        if fn is None:
            raise NotImplementedError(
                f"{type(self.backend).__name__} has no device state")
        return fn()

    def commit_device(self, state: dict) -> None:
        self.device_view().commit(state)

    # ------------------------------------------------------------------ misc

    def flush(self) -> Optional[int]:
        """Epoch boundary: apply any queued lifecycle ops (an async
        backend returns the epoch now reflected); a no-op on the
        synchronous backends."""
        fn = getattr(self.backend, "flush", None)
        return fn() if fn is not None else None

    @property
    def log(self) -> EventLog:
        return self.backend.log

    @property
    def now(self) -> float:
        return self._now

    def set_time(self, t: float) -> None:
        self._now = t
        self.backend.set_time(t)

    @staticmethod
    def ancestors(path: str) -> list[str]:
        return ancestor_paths(path)
