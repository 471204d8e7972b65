"""Device-resident domain state + in-step enforcement (the eBPF analogue).

Port of ``repro/core/controller.py``.  Enforcement decisions run inside
the serving engine's step from device-resident domain state, so a burst
is throttled in the same step it occurs; the host side only manages
lifecycle (create/freeze/thaw/remove) through the shared state tensors.

``charge_batch`` and ``slot_gate`` build a per-request ``ChainView`` and
dispatch into the attached ``PolicyProgram`` (``core/progs.py``).  On
CUDA tensors they launch the fused enforcement kernels
(``kernels/enforcement.py``); on CPU tensors they run the plain loop
below, which is the kernels' reference.

State layout (fixed capacity ``n``; index 0 is the root):
  usage/high/max/low : i32 pages          parent : i32 (-1 for root)
  priority           : i32 (0/1/2)        frozen : bool
  throttle_until     : i32 engine step    peak   : i32
  prog               : f32 (n, P) program parameter table

``charge_batch`` serializes grants within a step, slot by slot — the
same serialization the memcg page-counter hierarchy applies.

The sharded backend (``core/sharded.py``) stacks S such tables on a
leading axis: ``charge_batch`` and ``slot_gate`` given ``(S, n)`` state
and an ``(S, m)`` matrix of shard-local slots charge or gate every shard
at once (one kernel launch on CUDA); on CPU tensors they run the plain
per-shard loops ``_plain_charge_shards`` / ``_plain_gate_shards``, what
the reference's ``shard_map`` computes on each device.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import domains as D
from repro_torch.core.pressure import charge_stall_event, saturating_count
from repro_torch.core.progs import (ChainView, PolicyProgram, Request,
                                    as_program, as_programs, charge_decision,
                                    check_registry, gate_decision, pad_row,
                                    path_in_scope, registry_unknown_params,
                                    registry_width)

UNLIMITED = D.UNLIMITED
DEPTH = 4          # root / tenant / session / tool-call


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the entry points'
    default) needs a card; the CPU runs only when the caller asks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch sees no CUDA device; pass "
            "device='cpu' to run the plain torch path on the CPU")
    return dev


@dataclass(frozen=True)
class ControllerConfig:
    """Scalar knobs for the stock graduated-throttle program."""
    step_ms: float = 10.0             # engine-step duration the delays quantize to
    base_delay_ms: float = D.BASE_DELAY_MS
    max_delay_ms: float = D.MAX_DELAY_MS
    high_priority_discount: float = D.HIGH_PRIORITY_DISCOUNT
    overage_gain: float = D.OVERAGE_GAIN


def new_state(capacity_pages: int, n_domains: int = 64,
              prog: Optional[PolicyProgram] = None,
              device="cuda") -> dict:
    """Fresh device state with only the root (index 0) configured, on
    the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    progs = as_programs(prog)
    width = registry_width(progs)
    n = n_domains
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    st = {
        "usage": torch.zeros(n, **i32),
        "high": torch.full((n,), UNLIMITED, **i32),
        "max": torch.full((n,), UNLIMITED, **i32),
        "low": torch.zeros(n, **i32),
        "parent": torch.full((n,), -1, **i32),
        "priority": torch.full((n,), D.NORMAL, **i32),
        "frozen": torch.zeros(n, dtype=torch.bool, device=device),
        "active": torch.zeros(n, dtype=torch.bool, device=device),
        "throttle_until": torch.zeros(n, **i32),
        "peak": torch.zeros(n, **i32),
        "prog": torch.as_tensor(
            pad_row(progs[0].default_row(), width), **f32).repeat(n, 1),
        "prog_id": torch.zeros(n, **i32),
        # CPU scheduling rows (cpu.weight / cpu.max, core/sched.py)
        "weight": torch.full((n,), D.DEFAULT_WEIGHT, **i32),
        "cpu_max": torch.full((n,), UNLIMITED, **i32),
        "flat_weight": torch.zeros(n, **f32),
        "vruntime": torch.zeros(n, **f32),
        "cpu_used": torch.zeros(n, **i32),
        "cpu_stamp": torch.full((n,), -1, **i32),
        # PSI-style stall-event counters (core/pressure.py)
        "mem_stall": torch.zeros(n, **i32),
        "cpu_stall": torch.zeros(n, **i32),
    }
    st["max"][0] = capacity_pages
    st["high"][0] = capacity_pages
    st["active"][0] = True
    st["flat_weight"][0] = 1.0
    return st


def _ancestor_chain(parent, idx):
    """(..., DEPTH) ancestor indices of ``idx`` (self first), -1-padded."""
    chain = [idx]
    for _ in range(DEPTH - 1):
        prev = chain[-1]
        nxt = torch.where(prev >= 0, parent[torch.clamp(prev, min=0).long()],
                          torch.full_like(prev, -1))
        chain.append(nxt)
    return torch.stack(chain, dim=-1)


def _chain_view(state, usage, throttle_until, params, d) -> ChainView:
    """Masked ancestor-chain view for a request (or a batch of them):
    invalid entries are neutral — usage 0, limits UNLIMITED, not frozen,
    no throttle."""
    chain = _ancestor_chain(state["parent"], torch.clamp(d, min=0))
    valid = (chain >= 0) & (d >= 0)[..., None]
    cidx = torch.clamp(chain, min=0).long()
    di = torch.clamp(d, min=0).long()
    zero = torch.zeros_like(chain)
    unlimited = torch.full_like(chain, UNLIMITED)
    return ChainView(
        valid=valid,
        usage=torch.where(valid, usage[cidx], zero),
        high=torch.where(valid, state["high"][cidx], unlimited),
        max=torch.where(valid, state["max"][cidx], unlimited),
        low=torch.where(valid, state["low"][cidx], zero),
        frozen=valid & state["frozen"][cidx],
        throttle_until=torch.where(valid, throttle_until[cidx], zero),
        priority=state["priority"][di],
        params=params[di],
        prog_id=state["prog_id"][di],
    )


def step_reciprocal(progs) -> torch.Tensor:
    """f32 ``1 / step_ms`` of the primary program.  The reference writes
    ``ceil(delay_ms / step_ms)`` with ``step_ms`` a trace constant, and
    XLA folds that division into a multiply by the f32 reciprocal; the
    port multiplies by the same constant so throttle windows agree to
    the step."""
    return (torch.tensor(1.0, dtype=torch.float32)
            / torch.tensor(progs[0].step_ms, dtype=torch.float32))


def charge_batch(state: dict, dom, amt, step, prog=None):
    """Hierarchically charge ``amt[i]`` pages to domain ``dom[i]``,
    dispatching every decision into the attached ``PolicyProgram``.

    Returns (new_state, granted (m,) bool, stalled (m,) bool).
    ``stalled`` marks retryable denials (throttle/freeze/hard max).
    Zero-amount requests are gated only by freeze/throttle.  The fused
    kernel's wrapper routes: CUDA state launches the kernel, CPU state
    runs the plain loop below.  With a shard axis (``(S, n)`` state,
    ``(S, m)`` shard-local ``dom``, shared ``(m,)`` ``amt``) every shard
    charges its own row, and granted/stalled are ``(S, m)``.
    """
    from repro_torch.kernels.enforcement import fused_charge_batch
    return fused_charge_batch(state, dom.to(torch.int32),
                              amt.to(torch.int32), step, as_programs(prog))


def _plain_charge_batch(state: dict, dom, amt, step, progs):
    """The plain torch body of ``charge_batch`` — one slot after another,
    as ``_lax_charge_batch`` scans them in the reference.  It is the CPU
    path and the reference the CUDA kernel is held against."""
    progs = as_programs(progs)
    usage = state["usage"].clone()
    peak = state["peak"].clone()
    throttle_until = state["throttle_until"].clone()
    params = state["prog"].clone()
    mem_stall = state["mem_stall"].clone()
    step_t = torch.as_tensor(step, dtype=torch.int32, device=usage.device)
    inv_step = step_reciprocal(progs).to(usage.device)
    granted, stalled = [], []
    for i in range(dom.shape[0]):
        d, a = dom[i], amt[i]
        live = d >= 0
        view = _chain_view(state, usage, throttle_until, params, d)
        verdict, delay_ms, throttle = charge_decision(
            progs, view, Request(d, a, step_t))
        grant = live & verdict.grant
        stall = live & verdict.stall

        chain = _ancestor_chain(state["parent"], torch.clamp(d, min=0))
        cvalid = (chain >= 0) & live
        add = torch.where(cvalid & grant, a, torch.zeros_like(chain))
        usage.index_add_(0, torch.clamp(chain, min=0).long(), add)
        peak = torch.maximum(peak, usage)

        di = torch.clamp(d, min=0).long()
        dly = torch.ceil(delay_ms * inv_step).to(torch.int32)
        old = throttle_until[di]
        throttle_until[di] = torch.where(
            throttle & live, torch.maximum(old, step_t + dly), old)
        params[di] = torch.where(live, verdict.params, params[di])
        # PSI accounting: a stalled or throttled decision is one
        # memory-stall event on the charged domain, saturating
        mem_stall[di] = saturating_count(
            mem_stall[di],
            torch.where(live, charge_stall_event(stall, live & throttle),
                        torch.zeros_like(d)))
        granted.append(grant)
        stalled.append(stall)
    empty = torch.zeros(0, dtype=torch.bool, device=usage.device)
    new_state = dict(state, usage=usage, peak=peak,
                     throttle_until=throttle_until, prog=params,
                     mem_stall=mem_stall)
    return (new_state, torch.stack(granted) if granted else empty,
            torch.stack(stalled) if stalled else empty)


def shard_slice(state: dict, s: int) -> dict:
    """Shard ``s``'s ``(n,)`` table of an ``(S, n)`` state (views)."""
    return {k: v[s] for k, v in state.items()}


# the state columns a charge writes
CHARGED_KEYS = ("usage", "peak", "throttle_until", "prog", "mem_stall")


def _plain_charge_shards(state: dict, dom, amt, step, progs):
    """The plain charge over an ``(S, n)`` state: shard ``s`` charges
    ``dom[s]`` (shard-local indices, -1 off the shard) with the shared
    ``amt``, one ``_plain_charge_batch`` a shard, as ``shard_map`` runs
    the single-device charge on each device.  Returns (new_state,
    granted (S, m), stalled (S, m)).  The CPU path and the reference the
    shard-axis kernel is held against."""
    outs = [_plain_charge_batch(shard_slice(state, s), dom[s], amt, step,
                                progs) for s in range(dom.shape[0])]
    new_state = dict(state, **{k: torch.stack([o[0][k] for o in outs])
                               for k in CHARGED_KEYS})
    return (new_state, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def _plain_gate_shards(state: dict, slot_dom, step, progs):
    """The plain gate over an ``(S, n)`` state: ``(S, m)`` advance
    flags, one ``_plain_slot_gate`` a shard."""
    return torch.stack([_plain_slot_gate(shard_slice(state, s), slot_dom[s],
                                         step, progs)
                        for s in range(slot_dom.shape[0])])


def host_charge(state: dict, idx: int, amt: int) -> dict:
    """Unconditional hierarchical charge for host-side lifecycle moves
    (residual transfer on tool-domain close, thaw re-charge).  Never
    denied — the pages are already resident; this is bookkeeping."""
    usage = state["usage"].clone()
    parent = state["parent"].cpu().tolist()
    i = idx
    for _ in range(DEPTH):
        if i < 0:
            break
        usage[i] = max(0, int(usage[i]) + amt)
        i = parent[i]
    return dict(state, usage=usage,
                peak=torch.maximum(state["peak"], usage))


def uncharge_batch(state: dict, dom, amt):
    """Release pages (always succeeds); vectorized scatter over chains."""
    chain = _ancestor_chain(state["parent"], torch.clamp(dom, min=0))
    valid = (chain >= 0) & (dom >= 0)[:, None]
    sub = torch.where(valid, amt[:, None], torch.zeros_like(chain))
    usage = state["usage"].index_add(
        0, torch.clamp(chain, min=0).reshape(-1).long(), -sub.reshape(-1))
    return dict(state, usage=torch.clamp(usage, min=0))


def slot_gate(state: dict, slot_dom, step, prog=None):
    """May each slot advance this step?  Dispatches ``on_gate`` of the
    slot's domain program; CUDA state launches the fused gate kernel."""
    from repro_torch.kernels.enforcement import fused_slot_gate
    return fused_slot_gate(state, slot_dom.to(torch.int32), step,
                           as_programs(prog))


def _plain_slot_gate(state: dict, slot_dom, step, progs):
    """The plain torch body of ``slot_gate`` (all slots at once)."""
    view = _chain_view(state, state["usage"], state["throttle_until"],
                       state["prog"], slot_dom)
    step_t = torch.as_tensor(step, dtype=torch.int32, device=slot_dom.device)
    return (slot_dom >= 0) & gate_decision(as_programs(progs), view, step_t)


# -------------------------------------------------------------- host mirror


class DeviceDomainTable:
    """Host-side index allocator + lifecycle editor for the device state
    — the paper's 'lightweight user-space daemon'.  Lifecycle edits
    write the state tensors in place (they run between steps, never
    inside one)."""

    def __init__(self, capacity_pages: int, n_domains: int = 64,
                 cfg: ControllerConfig = ControllerConfig(),
                 prog: Optional[PolicyProgram] = None, device="cuda"):
        self.cfg = cfg
        self.n = n_domains
        self.device = resolve_device(device)
        self.progs = as_programs(prog if prog is not None else cfg)
        self.scopes = ["/"] * len(self.progs)
        self.state = new_state(capacity_pages, n_domains, self.progs,
                               self.device)
        self.index: dict[str, int] = {"/": 0}
        self._free = list(range(1, n_domains))   # heap: lowest index first

    # ------------------------------------------------------------ programs

    @property
    def prog(self) -> PolicyProgram:
        """The primary (slot 0) program."""
        return self.progs[0]

    @property
    def attach_scope(self) -> str:
        return self.scopes[0]

    def in_scope(self, path: str) -> bool:
        return path_in_scope(self.attach_scope, path)

    def attach(self, scope: str, prog: PolicyProgram) -> None:
        """Attach ``prog`` to the subtree at ``scope``.  A root attach
        resets the registry to this single program, every domain on its
        default row; a subtree attach composes (see the reference)."""
        prog = as_program(prog)
        if scope == "/":
            self.progs = (prog,)
            self.scopes = ["/"]
            rows = np.broadcast_to(prog.default_row(),
                                   (self.n, prog.n_params)).copy()
            self.state = dict(
                self.state, prog=torch.as_tensor(rows, device=self.device),
                prog_id=torch.zeros(self.n, dtype=torch.int32,
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
        old = self.state["prog"].cpu().numpy()
        rows = np.zeros((self.n, width), np.float32)
        keep = min(width, old.shape[1])
        rows[:, :keep] = old[:, :keep]
        ids = self.state["prog_id"].cpu().numpy().copy()
        for path, idx in self.index.items():
            if path_in_scope(scope, path):
                ids[idx] = k
                rows[idx] = pad_row(prog.default_row(), width)
        self.state = dict(self.state,
                          prog=torch.as_tensor(rows, device=self.device),
                          prog_id=torch.as_tensor(ids, device=self.device))

    def update_params(self, paths: list, kv: dict) -> None:
        """Retune the live program for the given domains — a state
        write.  Names unknown to every registered program raise."""
        unknown = registry_unknown_params(self.progs, kv)
        if unknown:
            raise KeyError(
                f"no registered program has param(s) {sorted(unknown)}; "
                f"knobs: {sorted(set().union(*(p.param_names for p in self.progs)))}")
        ids = self.state["prog_id"].cpu().tolist()
        prog = self.state["prog"]
        for p in paths:
            idx = self.index[p]
            pr = self.progs[ids[idx]]
            for k, v in kv.items():
                if k in pr.param_names:
                    prog[idx, pr.col(k)] = float(v)

    # ------------------------------------------------------------ lifecycle

    def create(self, path: str, *, high: int = UNLIMITED, max: int = UNLIMITED,
               low: int = 0, priority: int = D.NORMAL,
               weight: int = D.DEFAULT_WEIGHT,
               cpu_max: int = UNLIMITED) -> int:
        if path in self.index:
            raise FileExistsError(path)
        parent_path = path.rsplit("/", 1)[0] or "/"
        pidx = self.index[parent_path]
        idx = heapq.heappop(self._free)
        self.index[path] = idx
        st = self.state
        for key, val in (("high", high), ("max", max), ("low", low),
                         ("parent", pidx), ("priority", priority),
                         ("usage", 0), ("peak", 0), ("frozen", False),
                         ("active", True), ("throttle_until", 0),
                         ("weight", weight), ("cpu_max", cpu_max),
                         ("flat_weight", 0.0), ("vruntime", 0.0),
                         ("cpu_used", 0), ("cpu_stamp", -1),
                         ("mem_stall", 0), ("cpu_stall", 0)):
            st[key][idx] = val
        # new domains inherit their parent's live row and program slot
        st["prog"][idx] = st["prog"][pidx]
        st["prog_id"][idx] = st["prog_id"][pidx]
        return idx

    def remove(self, path: str) -> None:
        idx = self.index.pop(path)
        residual = int(self.state["usage"][idx])
        if residual:
            # release residual charges up the chain (host-side lifecycle op)
            self.state = uncharge_batch(
                self.state,
                torch.tensor([idx], dtype=torch.int32, device=self.device),
                torch.tensor([residual], dtype=torch.int32,
                             device=self.device))
        st = self.state
        for key, val in (("active", False), ("frozen", False),
                         ("parent", -1), ("weight", D.DEFAULT_WEIGHT),
                         ("cpu_max", UNLIMITED), ("flat_weight", 0.0),
                         ("vruntime", 0.0), ("cpu_used", 0),
                         ("cpu_stamp", -1), ("mem_stall", 0),
                         ("cpu_stall", 0), ("prog_id", 0)):
            st[key][idx] = val
        heapq.heappush(self._free, idx)

    def set_frozen(self, path: str, flag: bool) -> None:
        self.state["frozen"][self.index[path]] = flag

    def usage(self, path: str) -> int:
        return int(self.state["usage"][self.index[path]])

    def peak(self, path: str) -> int:
        return int(self.state["peak"][self.index[path]])
