"""Sharded multi-tenant backend: S domain tables as a leading axis.

Port of ``repro/core/sharded.py``.  The third implementation of the
``Backend`` protocol (after the host tree and the single-device table):
domain state lives as ``(n_shards, n_domains)`` tensors, one independent
local table a device group.  The reference spreads the groups over a
1-axis device mesh under ``shard_map``; on one card the shards are the
leading axis of one table, and the in-step charge and gate serve every
shard in one kernel launch.  Placement is by *tenant subtree*: the first
path component below ``/`` picks a shard (round-robin), and every
descendant (sessions, tool-call leases) inherits it, so one tenant's
burst is charged, throttled and frozen entirely in its own group.

Enforcement runs in two modes, as in ``DeviceTableBackend``:

  * host-driven (lifecycle, replay, cross-validation): ``try_charge``
    charges the owning shard's slice and also enforces the *global*
    root capacity (the sum of the shard roots' usage), so grants match
    ``HostTreeBackend`` exactly; one device-to-host read a charge;
  * in-step (serving engine): ``device_view()`` returns functions over
    *global* handles (``shard * n_domains + local``) that scatter the
    per-slot requests into an ``(n_shards, m)`` matrix of shard-local
    indices and run the per-shard charge, gate or schedule, with no
    traffic between shards on the hot path.

Host-side reads reconcile across shards: ``/`` ``memory.current`` is the
sum of the shard roots' usage, ``memory.peak`` the sum of their peaks,
and ``memory.events`` flags any throttled root.  The root peak is what
provisioning needs (each group's high-water is what it must hold), but
it is an *upper bound* on the instantaneous global peak whenever groups
peak at different times (exact for traffic confined to one shard).

``n_shards`` is given explicitly and defaults to 1, what the reference's
``len(jax.devices())`` gives on one device.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import domains as D
from repro_torch.core import pressure as PSI
from repro_torch.core import sched as Sched
from repro_torch.core.cgroup import (ChargeTicket, DomainSpec,
                                     ancestor_paths, parent_path)
from repro_torch.core.events import Ev, EventLog
from repro_torch.core.progs import (PolicyProgram, as_program, as_programs,
                                    check_registry, pad_row, path_in_scope,
                                    registry_unknown_params, registry_width)

UNLIMITED = D.UNLIMITED

# the columns a scheduling round writes
_SCHED_KEYS = ("vruntime", "cpu_used", "cpu_stamp", "cpu_stall")
# the columns the host-side schedule flattens (besides parent and prog)
_FLAT_KEYS = ("usage", "high", "max", "low", "priority", "frozen", "active",
              "throttle_until", "weight", "cpu_max", "flat_weight",
              "vruntime", "cpu_used", "cpu_stamp", "cpu_stall", "prog_id")
# snapshot key, dtype of the state column (parent and params apart)
_RESTORE = (("usage", torch.int32), ("peak", torch.int32),
            ("high", torch.int32), ("max", torch.int32),
            ("low", torch.int32), ("priority", torch.int32),
            ("frozen", torch.bool), ("active", torch.bool),
            ("throttle_until", torch.int32), ("weight", torch.int32),
            ("cpu_max", torch.int32), ("flat_weight", torch.float32),
            ("vruntime", torch.float32), ("cpu_used", torch.int32),
            ("cpu_stamp", torch.int32), ("mem_stall", torch.int32),
            ("cpu_stall", torch.int32), ("prog_id", torch.int32))


def _np(t) -> np.ndarray:
    """A host copy of a state tensor."""
    return t.detach().cpu().numpy().copy()


def _stacked_state(capacity: int, n_shards: int, n_domains: int, progs,
                   device) -> dict:
    """Per-shard local tables: every shard's local index 0 is that
    device group's root, capped at the full pool capacity."""
    one = C.new_state(capacity, n_domains, progs, device)
    return {k: v.unsqueeze(0).repeat((n_shards,) + (1,) * v.dim())
            for k, v in one.items()}


def _flat_parent(parent: torch.Tensor) -> torch.Tensor:
    """``(S, n)`` shard-local parents as one ``(S n,)`` column of global
    handles (-1 stays -1)."""
    S, n = parent.shape
    base = torch.arange(S, dtype=torch.int32, device=parent.device)[:, None]
    return torch.where(parent >= 0, parent + base * n, parent).reshape(-1)


def _uncharge_global(state: dict, dom, amt) -> dict:
    """``uncharge_batch`` over global handles: the shards seen as one
    flat table whose parents are rebased, which is each shard's own
    uncharge (the shards' chains are disjoint, the clamp elementwise)."""
    flat = {"usage": state["usage"].reshape(-1),
            "parent": _flat_parent(state["parent"])}
    usage = C.uncharge_batch(flat, dom.to(torch.int32),
                             amt.to(torch.int32))["usage"]
    return dict(state, usage=usage.reshape(state["usage"].shape))


class ShardedDeviceView:
    """The in-step slice of the sharded backend: the live ``(S, n)``
    state plus enforcement functions over *global* handles.  Each
    function scatters its flat per-slot requests to the owning shards,
    runs the single-table decision per shard (the charge and the gate
    in one kernel launch over all shards on the card) and gathers flat
    results, so the engine's step is backend-agnostic."""

    def __init__(self, backend: "ShardedTableBackend"):
        self._backend = backend
        self.cfg = backend.cfg
        self.n_shards = backend.n_shards
        self.per_shard = backend.per_shard_domains

    @property
    def state(self) -> dict:
        return self._backend.state

    @property
    def prog(self) -> PolicyProgram:
        return self._backend.prog

    @property
    def progs(self) -> tuple:
        return self._backend.progs

    def _split(self, dom):
        """``(valid, shard, dom2)``: each slot's owning shard and the
        ``(S, m)`` matrix of shard-local indices, -1 off the shard."""
        dom = dom.to(torch.int32)
        valid = dom >= 0
        shard = torch.where(valid, torch.div(dom, self.per_shard,
                                             rounding_mode="floor"), 0)
        local = torch.where(valid, dom % self.per_shard, -1)
        ids = torch.arange(self.n_shards, dtype=torch.int32,
                           device=dom.device)
        sel = (shard[None, :] == ids[:, None]) & valid[None, :]
        return valid, shard.long(), torch.where(sel, local[None, :], -1)

    def _gather(self, per_shard, shard, valid):
        rows = torch.arange(shard.shape[0], device=shard.device)
        return per_shard[shard, rows] & valid

    def charge(self, state, dom, amt, step):
        """In-step hierarchical charge: (state, granted, stalled); every
        shard serves its own tenants' requests in the same launch."""
        valid, shard, dom2 = self._split(dom)
        new_state, g2, s2 = C.charge_batch(state, dom2, amt, step,
                                           self.progs)
        return (new_state, self._gather(g2, shard, valid),
                self._gather(s2, shard, valid))

    def account(self, state, dom, amt):
        """Post-hoc unconditional charge (the user-space baseline)."""
        return self.uncharge(state, dom, -amt)

    def uncharge(self, state, dom, amt):
        return _uncharge_global(state, dom, amt)

    def gate(self, state, dom, step):
        """Per-slot advance gate (no frozen/throttled ancestor)."""
        valid, shard, dom2 = self._split(dom)
        return self._gather(C.slot_gate(state, dom2, step, self.progs),
                            shard, valid)

    def schedule(self, state, dom, cost, step, budget):
        """In-step weighted scheduling: every shard runs the shared
        ``schedule_decision`` over its own tenants' slots with a
        *per-shard* budget (the per-device-group convention, like
        ``pool_pages``)."""
        valid, shard, dom2 = self._split(dom)
        outs = [Sched.schedule_decision(self.progs, C.shard_slice(state, s),
                                        dom2[s], cost, step, budget)
                for s in range(self.n_shards)]
        new_state = dict(state, **{
            k: torch.stack([o[0][k] for o in outs]) for k in _SCHED_KEYS})
        advance = torch.stack([o[1] for o in outs])
        return new_state, self._gather(advance, shard, valid)

    def commit(self, state: dict) -> None:
        self._backend.state = state


class ShardedTableBackend:
    """Sharded backend: per-tenant device-group placement, per-shard
    in-step enforcement, host-side reconciliation.  Lifecycle edits
    write the state tensors in place (between steps, never inside one),
    as ``controller.DeviceDomainTable`` does."""

    def __init__(self, capacity: int, n_domains: int = 64, cfg=None,
                 log: Optional[EventLog] = None, *,
                 n_shards: Optional[int] = None,
                 prog: Optional[PolicyProgram] = None, device="cuda"):
        self.device = C.resolve_device(device)
        self.cfg = cfg or C.ControllerConfig()
        self.capacity = capacity
        self.progs = as_programs(prog if prog is not None else self.cfg)
        self.scopes = ["/"] * len(self.progs)
        self.n_shards = int(n_shards or 1)
        if self.n_shards < 1:
            raise ValueError(f"n_shards {n_shards}: want at least 1")
        self.per_shard_domains = n_domains
        self.state = _stacked_state(capacity, self.n_shards, n_domains,
                                    self.progs, self.device)
        # path -> (shard, local idx); "/" is every shard's local root but
        # addressed through shard 0
        self.index: dict[str, tuple[int, int]] = {"/": (0, 0)}
        self._free = [list(range(1, n_domains))    # heaps: lowest first
                      for _ in range(self.n_shards)]
        self._tenant_shard: dict[str, int] = {}
        self._next_shard = 0
        self.log = log if log is not None else EventLog()
        self._now = 0.0

    def _put(self, arr) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(arr), device=self.device)

    def _i32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- programs

    @property
    def prog(self) -> PolicyProgram:
        """The primary (slot 0) program."""
        return self.progs[0]

    @property
    def attach_scope(self) -> str:
        return self.scopes[0]

    def attach(self, scope: str, prog: PolicyProgram) -> None:
        """The compose semantics of ``DeviceDomainTable.attach``: a root
        attach resets the registry; a subtree attach takes (or replaces)
        a registry slot and moves only in-scope domains to it, rows
        padded to the registry width, per shard."""
        prog = as_program(prog)
        S, n = self.n_shards, self.per_shard_domains
        if scope == "/":
            self.progs = (prog,)
            self.scopes = ["/"]
            rows = np.broadcast_to(prog.default_row(), (S, n, prog.n_params))
            self.state = dict(
                self.state, prog=self._put(rows),
                prog_id=torch.zeros((S, n), dtype=torch.int32,
                                    device=self.device))
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
        old = _np(self.state["prog"])
        rows = np.zeros((S, n, width), np.float32)
        keep = min(width, old.shape[2])
        rows[:, :, :keep] = old[:, :, :keep]
        ids = _np(self.state["prog_id"])
        for path, (s, i) in self.index.items():
            if path_in_scope(scope, path):
                ids[s, i] = k
                rows[s, i] = pad_row(prog.default_row(), width)
        self.state = dict(self.state, prog=self._put(rows),
                          prog_id=self._put(ids))

    def update_params(self, path: str, kv: dict) -> None:
        unknown = registry_unknown_params(self.progs, kv)
        if unknown:
            raise KeyError(
                f"no registered program has param(s) {sorted(unknown)}; "
                f"knobs: {sorted(set().union(*(p.param_names for p in self.progs)))}")
        ids = _np(self.state["prog_id"])
        prog = self.state["prog"]
        for p in self._subtree(path):
            s, i = self.index[p]
            pr = self.progs[int(ids[s, i])]
            for k, v in kv.items():
                if k not in pr.param_names:
                    continue
                if p == "/":             # root params on every shard's root
                    prog[:, 0, pr.col(k)] = float(v)
                else:
                    prog[s, i, pr.col(k)] = float(v)

    def _recompute_flat(self) -> None:
        """Re-flatten hierarchical weights across the *global* logical
        tree (lifecycle rate), with the host math every backend uses
        (``flat_weights_by_path``); every shard's local root mirrors the
        global root (flat 1.0)."""
        w = _np(self.state["weight"])
        flat = Sched.flat_weights_by_path(
            {p: int(w[s, i]) for p, (s, i) in self.index.items()})
        arr = np.zeros((self.n_shards, self.per_shard_domains), np.float32)
        arr[:, 0] = 1.0
        for p, (s, i) in self.index.items():
            if p != "/":
                arr[s, i] = flat[p]
        self.state["flat_weight"] = self._put(arr)

    # ------------------------------------------------------------ placement

    @property
    def n_domains(self) -> int:
        """Global handle space (shard-major), for flat consumers."""
        return self.n_shards * self.per_shard_domains

    def placement(self) -> dict:
        """tenant path -> shard (device group)."""
        return dict(self._tenant_shard)

    def _shard_for(self, path: str) -> int:
        if path == "/":
            return 0
        tenant = "/" + path.strip("/").split("/")[0]
        if tenant not in self._tenant_shard:
            self._tenant_shard[tenant] = self._next_shard % self.n_shards
            self._next_shard += 1
        return self._tenant_shard[tenant]

    def _handle(self, shard: int, idx: int) -> int:
        return shard * self.per_shard_domains + idx

    def device_view(self) -> ShardedDeviceView:
        return ShardedDeviceView(self)

    def _adopt(self, shard: int, sub: dict, keys) -> None:
        """Write shard ``shard``'s new ``keys`` rows into the table."""
        for k in keys:
            self.state[k][shard] = sub[k]

    # ------------------------------------------------------------ lifecycle

    def mkdir(self, path: str, spec: DomainSpec) -> int:
        if len(ancestor_paths(path)) > C.DEPTH:
            raise ValueError(f"{path}: deeper than DEPTH={C.DEPTH}")
        if path in self.index:
            raise FileExistsError(path)
        shard = self._shard_for(path)
        parent = parent_path(path)
        pshard, pidx = self.index[parent]
        if parent != "/":
            if pshard != shard:
                raise ValueError(f"{path} crosses its tenant's shard")
        else:
            pidx = 0                       # this shard's local root
        idx = heapq.heappop(self._free[shard])
        self.index[path] = (shard, idx)
        st = self.state
        for key, val in (("high", spec.high), ("max", spec.max),
                         ("low", spec.low), ("parent", pidx),
                         ("priority", spec.priority), ("usage", 0),
                         ("peak", 0), ("frozen", False), ("active", True),
                         ("throttle_until", 0), ("weight", spec.weight),
                         ("cpu_max", spec.cpu_max), ("vruntime", 0.0),
                         ("cpu_used", 0), ("cpu_stamp", -1),
                         ("mem_stall", 0), ("cpu_stall", 0)):
            st[key][shard, idx] = val
        # children inherit their parent's live row AND program slot, so a
        # domain created after a subtree attach runs the subtree's program
        st["prog"][shard, idx] = st["prog"][shard, pidx]
        st["prog_id"][shard, idx] = st["prog_id"][shard, pidx]
        self._recompute_flat()
        self.log.emit(self._now, Ev.CREATE, path, high=spec.high,
                      max=spec.max, shard=shard)
        return self._handle(shard, idx)

    def rmdir(self, path: str, transfer_residual: bool) -> int:
        shard, idx = self.index[path]
        residual = int(self.state["usage"][shard, idx])
        parent = parent_path(path)
        if residual:
            self.uncharge(path, residual)
        st = self.state
        for key, val in (("active", False), ("frozen", False),
                         ("parent", -1), ("weight", D.DEFAULT_WEIGHT),
                         ("cpu_max", UNLIMITED), ("vruntime", 0.0),
                         ("cpu_used", 0), ("cpu_stamp", -1),
                         ("mem_stall", 0), ("cpu_stall", 0),
                         ("prog_id", 0)):
            st[key][shard, idx] = val
        del self.index[path]
        heapq.heappush(self._free[shard], idx)
        self._recompute_flat()
        if transfer_residual and residual and parent is not None:
            self.charge_unchecked(parent, residual)
        self.log.emit(self._now, Ev.REMOVE, path)
        return residual

    def exists(self, path: str) -> bool:
        return path in self.index

    def paths(self) -> list[str]:
        return list(self.index)

    def handle(self, path: str) -> int:
        return self._handle(*self.index[path])

    def path_of(self, handle: int) -> str:
        key = divmod(handle, self.per_shard_domains)
        for p, si in self.index.items():
            if si == key:
                return p
        raise KeyError(handle)

    # --------------------------------------------------- charging (host path)

    def try_charge(self, path: str, pages: int,
                   step: Optional[int]) -> ChargeTicket:
        """Global root capacity, then the owning shard's charge: the
        shard-local tables each cap at the full pool, so the cross-shard
        sum is checked here, from the live root max (the host tree's
        root-max contract with ``write("/", "memory.max", v)``).  All on
        the device, one read of the packed flags back."""
        if step is None:
            step = int(self._now)
        shard, idx = self.index[path]
        st = self.state
        cap = st["max"][0, 0]
        root_ok = (cap >= UNLIMITED) | (st["usage"][:, 0].sum() + pages
                                        <= cap)
        # a denied request reaches the charge as a dead slot
        dom = ((idx + 1) * root_ok.to(torch.int32) - 1).reshape(1)
        sub, granted, stalled = C.charge_batch(
            C.shard_slice(st, shard), dom, self._i32([pages]), step,
            self.progs)
        # a global-root-capacity denial is a stall event at the charged
        # domain, as the host reference (the root max on the ancestor
        # chain) counts it, saturating like every other site
        stall = sub["mem_stall"]
        stall[idx] = PSI.saturating_count(stall[idx],
                                          (~root_ok).to(torch.int32))
        self._adopt(shard, sub, C.CHARGED_KEYS)
        window = torch.clamp(sub["throttle_until"][idx] - step, min=0)
        g, s, ok, w = torch.stack([granted[0].to(torch.int32),
                                   stalled[0].to(torch.int32),
                                   root_ok.to(torch.int32),
                                   window.to(torch.int32)]).tolist()
        if not ok:
            return ChargeTicket(granted=False, stalled=True, blocked_by="/")
        return ChargeTicket(granted=bool(g), stalled=bool(s),
                            delay_ms=w * self.prog.step_ms)

    def uncharge(self, path: str, pages: int) -> None:
        shard, idx = self.index[path]
        sub = C.uncharge_batch(C.shard_slice(self.state, shard),
                               self._i32([idx]), self._i32([pages]))
        self._adopt(shard, sub, ("usage",))

    def charge_unchecked(self, path: str, pages: int) -> None:
        shard, idx = self.index[path]
        sub = C.host_charge(C.shard_slice(self.state, shard), idx, pages)
        self._adopt(shard, sub, ("usage", "peak"))

    # ------------------------------------------------ scheduling (host path)

    def schedule(self, paths: list, costs: list, step: int,
                 budget: int) -> list:
        """Host-driven weighted scheduling round, bit-exact with the
        host reference: the shards are flattened to one global view
        (parents rebased, as in ``snapshot``) and run through
        ``schedule_decision`` with the global budget; the updated
        accounts go back per shard.  The in-step path
        (``device_view().schedule``) runs per shard with a per-shard
        budget instead."""
        st = self.state
        S, n = self.n_shards, self.per_shard_domains
        flat = {k: st[k].reshape(-1) for k in _FLAT_KEYS}
        flat["parent"] = _flat_parent(st["parent"])
        flat["prog"] = st["prog"].reshape(S * n, -1)
        dom = self._i32([self._handle(*self.index[p]) for p in paths])
        new, advance = Sched.schedule_decision(
            self.progs, flat, dom, self._i32(list(costs)), int(step),
            int(budget))
        self.state = dict(st, **{k: new[k].reshape(S, n)
                                 for k in _SCHED_KEYS})
        return [bool(a) for a in advance.cpu().tolist()]

    # ------------------------------------------------------ subtree control

    def _subtree(self, path: str) -> list[str]:
        return [p for p in self.index if path_in_scope(path, p)]

    def _set_frozen(self, path: str, flag: bool) -> None:
        frozen = self.state["frozen"]
        for p in self._subtree(path):
            shard, idx = self.index[p]
            if p == "/":                  # freeze every device group's root
                frozen[:, 0] = flag
            else:
                frozen[shard, idx] = flag

    def freeze(self, path: str) -> None:
        self._set_frozen(path, True)
        self.log.emit(self._now, Ev.FREEZE, path)

    def thaw(self, path: str) -> None:
        self._set_frozen(path, False)
        self.log.emit(self._now, Ev.THAW, path)

    def kill(self, path: str) -> int:
        """Atomic subtree kill, as ``DeviceTableBackend``'s: usage
        released from the owning shard's chain, every node retired in
        place (still registered, denying charges through frozen)."""
        shard, idx = self.index[path]
        freed = int(self.state["usage"][shard, idx])
        if freed:
            self.uncharge(path, freed)
        st = self.state
        for p in self._subtree(path):
            s, i = self.index[p]
            st["usage"][s, i] = 0
            st["active"][s, i] = False
            st["frozen"][s, i] = True
        self.log.emit(self._now, Ev.OOM_KILL, path, freed=freed)
        return freed

    # --------------------------------------------------------- control files

    _FILE_KEY = {"memory.current": "usage", "memory.peak": "peak",
                 "memory.high": "high", "memory.max": "max",
                 "memory.low": "low", "memory.priority": "priority",
                 "cgroup.freeze": "frozen", "cpu.weight": "weight",
                 "cpu.max": "cpu_max"}

    def reconcile(self) -> dict:
        """Host-side reconciliation of the global root across device
        groups, gathered shard by shard: usage and peak sum over the
        shard-local roots, throttle is a flag (any group throttled).
        The chaos harness's seam: the optional ``reconcile_hook(shard)``
        attribute runs between per-shard gathers, where fault injection
        (or a concurrent lifecycle op) can land mid-reconciliation."""
        hook = getattr(self, "reconcile_hook", None)
        usage = peak = 0
        throttled = False
        for s in range(self.n_shards):
            if hook is not None:
                hook(s)
            u, p, t = self.state["usage"][s, 0], self.state["peak"][s, 0], \
                self.state["throttle_until"][s, 0]
            usage += int(u)
            peak += int(p)
            throttled |= bool(t > 0)
        return {"usage": usage, "peak": peak, "throttled": throttled}

    def read(self, path: str, file: str):
        if file in PSI.STALL_FILES:
            # stall counters are local per domain; roll the subtree up
            # host-side over the logical path tree
            key = "mem_stall" if file == "memory.stall" else "cpu_stall"
            col = _np(self.state[key])
            return PSI.subtree_counts_by_path(
                {p: int(col[s, i]) for p, (s, i) in self.index.items()
                 if path_in_scope(path, p)})[path]
        if path == "/":
            # reconcile the global root across device groups
            if file == "memory.current":
                return self.reconcile()["usage"]
            if file == "memory.peak":
                return self.reconcile()["peak"]
            if file == "memory.events":
                # a flag, not a shard count: DeviceTableBackend semantics
                return {"high": 0, "max": 0,
                        "throttle": int(self.reconcile()["throttled"]),
                        "oom_kill": 0}
            return int(self.state[self._FILE_KEY[file]][0, 0])
        shard, idx = self.index[path]
        if file == "memory.events":
            tu = int(self.state["throttle_until"][shard, idx])
            return {"high": 0, "max": 0, "throttle": int(tu > 0),
                    "oom_kill": 0}
        return int(self.state[self._FILE_KEY[file]][shard, idx])

    def write(self, path: str, file: str, value) -> None:
        if file == "cgroup.freeze":
            (self.freeze if int(value) else self.thaw)(path)
            return
        if file == "cpu.weight":
            value = Sched.check_weight(value)
        col = self.state[self._FILE_KEY[file]]
        if path == "/":                  # root limits apply to every group
            if file == "memory.max":
                self.capacity = int(value)
            col[:, 0] = int(value)
        else:
            shard, idx = self.index[path]
            col[shard, idx] = int(value)
        if file == "cpu.weight":
            self._recompute_flat()

    # --------------------------------------------------------------- queries

    def snapshot(self) -> dict:
        """One host copy; rows addressable by global handle (``shard *
        n_domains + local``), parents rebased to global handles, plus
        the reconciled root usage."""
        st = {k: _np(v) for k, v in self.state.items()}
        S, n = self.n_shards, self.per_shard_domains
        base = (np.arange(S) * n)[:, None]
        parent = st["parent"]
        parent = np.where(parent >= 0, parent + base, -1).reshape(-1)
        snap = {"paths": list(self.index),
                "index": {p: self._handle(*si)
                          for p, si in self.index.items()},
                "parent": parent,
                "params": st["prog"].reshape(S * n, -1)}
        for key in ("usage", "high", "max", "active", "peak", "low",
                    "priority", "frozen", "throttle_until", "weight",
                    "cpu_max", "flat_weight", "vruntime", "cpu_used",
                    "cpu_stamp", "mem_stall", "cpu_stall", "prog_id"):
            snap[key] = st[key].reshape(-1)
        snap.update(root_usage=int(st["usage"][:, 0].sum()),
                    root_handles=[s * n for s in range(S)],
                    placement=dict(self._tenant_shard),
                    next_shard=self._next_shard)
        return snap

    def restore(self, snap: dict) -> None:
        """Rebuild placement, index and the stacked state from a
        ``snapshot()`` dict: crash recovery onto a freshly constructed
        backend of the same ``n_shards`` and ``n_domains``.  Call after
        ``attach``."""
        S, n = self.n_shards, self.per_shard_domains
        if len(snap["usage"]) != S * n:
            raise ValueError("snapshot/shard shape mismatch")
        self.index = {p: divmod(h, n) for p, h in snap["index"].items()}
        self.index["/"] = (0, 0)
        used = {s: {0} for s in range(S)}
        for s, i in self.index.values():
            used[s].add(i)
        self._free = [[i for i in range(1, n) if i not in used[s]]
                      for s in range(S)]
        for heap in self._free:
            heapq.heapify(heap)
        self._tenant_shard = dict(snap.get("placement", {}))
        self._next_shard = int(snap.get("next_shard", 0))
        base = (np.arange(S) * n)[:, None]
        parent = np.asarray(snap["parent"]).reshape(S, n)
        parent = np.where(parent >= 0, parent - base, -1)
        new = dict(self.state)
        for key, dtype in _RESTORE:
            if key in snap:
                arr = np.asarray(snap[key]).reshape(S, n)
                new[key] = torch.tensor(arr, dtype=dtype, device=self.device)
        new["parent"] = torch.tensor(parent, dtype=torch.int32,
                                     device=self.device)
        new["prog"] = torch.tensor(
            np.asarray(snap["params"]).reshape(S, n, -1),
            dtype=torch.float32, device=self.device)
        self.state = new
        if "flat_weight" not in snap:      # older snapshot: re-flatten
            self._recompute_flat()

    def set_time(self, t: float) -> None:
        self._now = t
