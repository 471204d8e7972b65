"""Multi-tenant continuous-batching engine with AgentCgroup enforcement.

Port of ``repro/serving/engine.py``.  Every engine step advances all
active slots by one token (prompt and tool-result tokens are force-fed
one per step, so every context-page allocation flows through the same
charge path a decoded token uses).  The controller runs in one of:

  * ``inkernel``  — the AgentCgroup design: ``device_view().charge`` runs
    inside the step, on the device (the fused charge kernel on a card);
    a slot whose page charge is denied (hard limit, freeze, throttle)
    does not advance this same step.
  * ``userspace`` — the baseline the paper's §4.2 criticizes: a daemon
    polls usage and gates slots one or more steps late.
  * ``nolimit``   — accounting only.

Host-side daemon work (lifecycle only, as in the paper): admission,
per-tool-call child domains with intent-hint highs, freeze/thaw with
state offload, downward feedback, and (with ``adaptive=``) the
closed-loop pressure retuner polled at step boundaries.  The control
plane is the device table (``backend="device"``), the sharded table
(``backend="sharded"``, ``n_shards`` device groups of ``pool_pages``
each) or either behind the async lifecycle daemon (``backend="async"``,
``async_inner``): there the lifecycle work runs on the daemon thread in
FIFO epochs applied at the ``cg.flush()`` each step issues before it
reads the control state, bit-exact with the synchronous backends.  A
poisoned daemon surfaces there as ``DaemonError``; the engine rebuilds
the backend from the last step-boundary snapshot and its own session
state, and the step goes on.

On a card the step's device work after the charge (the gated merge, the
decode over every layer, the greedy sample) is one CUDA graph
(``StepGraph``), replayed each step from buffers whose addresses never
change; on the CPU it runs eagerly.  The tensors' device decides, nothing
else.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels, tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core import domains as D
from repro_torch.core import pressure as PSI
from repro_torch.core.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.core.cgroup import AgentCgroup, DeviceTableBackend, DomainSpec
from repro_torch.core.controller import ControllerConfig, resolve_device
from repro_torch.core.daemon import AsyncDaemonBackend, DaemonError
from repro_torch.core.events import Ev, EventLog
from repro_torch.core.intent import Hint
from repro_torch.core.progs import PolicyProgram
from repro_torch.core.sharded import ShardedTableBackend
from repro_torch.models import model as M
from repro_torch.serving.kvcache import PageAccountant, SlotCaches
from repro_torch.serving.sampling import sample
from repro_torch.serving.session import Session, SState
from repro_torch.tracing import span


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    s_max: int = 512
    pool_pages: int = 256                # KV pool per device group
    page_tokens: int = 16
    mode: str = "inkernel"               # inkernel | userspace | nolimit
    backend: str = "device"              # device | sharded | async
    async_inner: str = "device"          # async: the wrapped backend
    n_shards: Optional[int] = None       # sharded: device-group count (1)
    ctrl: ControllerConfig = ControllerConfig(step_ms=10.0)
    # 0 samples greedily, as the reference does; ``report()`` is
    # field-identical to the JAX engine's at temperature 0 only (above
    # 0 the port draws from a ``torch.Generator``, the reference from
    # its PRNG key)
    temperature: float = 0.0
    # daemon knobs
    freeze_threshold: float = 0.97
    thaw_threshold: float = 0.80
    feedback_patience_steps: int = 40
    evict_patience_steps: int = 400
    userspace_poll_steps: int = 8        # PSI-poll analogue
    userspace_react_steps: int = 4       # daemon decision+write latency
    use_intent: bool = True
    use_tool_domains: bool = True
    use_freeze: bool = True              # graceful-degradation step 2
    # weighted CPU scheduler (cpu.weight / cpu.max): at most
    # ``sched_slots`` weighted slots advance per step; None keeps the
    # binary slot gate
    sched_slots: Optional[int] = None
    # closed-loop adaptive retuner over memory.pressure / cpu.pressure
    # (core/adaptive.py): polls at step boundaries, bumps soft limits /
    # retunes params through state writes.  None (the default) keeps
    # behavior bit-identical — the loop never runs, no pressure file is
    # read.
    adaptive: Optional[AdaptiveConfig] = None
    # intent hints in engine pages (LOW/MEDIUM/HIGH priority of Hint enum)
    intent_high_pages: Optional[dict] = None
    session_high: Optional[dict] = None  # sid -> memory.high (pages)
    max_steps: int = 20_000


@dataclass
class EngineMetrics:
    peak_pool_pages: int = 0             # max root usage at a step's end
    overshoot_pages: int = 0             # max pages over pool budget
    session_overshoot_pages: int = 0     # max pages over any session high
    throttle_triggers: int = 0
    n_feedbacks: int = 0
    n_freezes: int = 0
    n_thaws: int = 0
    n_evictions: int = 0
    n_rebuilds: int = 0                  # poisoned-daemon backend rebuilds
    steps: int = 0


class StepGraph:
    """One CUDA graph of ``fn``, a callable that reads only tensors whose
    addresses never change and is the same on every call.  ``run(fn)``
    calls it eagerly the first time (which warms cuBLAS, builds the
    kernels and sets their attributes), captures it the second time and
    replays the capture from then on: capture executes nothing, so the
    second call replays too.  The kernel wrappers count their launches in
    Python, which a replay does not run: the capture's count is taken
    back off, and added on every replay, so ``kernels.launch_counts()``
    counts what the device ran."""

    def __init__(self):
        self.graph = None
        self.out = None
        self.launches: dict = {}     # a wrapper's launches in one replay
        self.warm = False

    def run(self, fn):
        """(fn's output, whether it came from a replay).  A replay's
        output is the same tensor each time, overwritten by the next."""
        if not self.warm:
            self.warm = True
            return fn(), False
        if self.graph is None:
            self._capture(fn)
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.out, True

    def _capture(self, fn) -> None:
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread-local: the async backend's daemon thread may call the
        # CUDA runtime while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        after = kernels.launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        kernels.add_launches(self.launches, -1)
        self.graph, self.out = graph, out


class Engine:
    def __init__(self, cfg: ModelConfig, params, *,
                 ecfg: EngineConfig = EngineConfig(), seed: int = 0,
                 device="cuda"):
        if ecfg.backend not in ("device", "sharded", "async") or \
                ecfg.async_inner not in ("device", "sharded"):
            raise ValueError(f"unknown backend {ecfg.backend!r} "
                             f"(async_inner {ecfg.async_inner!r})")
        if ecfg.mode not in ("inkernel", "userspace", "nolimit"):
            raise ValueError(f"unknown mode {ecfg.mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.caches = SlotCaches(cfg, ecfg.max_slots, ecfg.s_max,
                                 self.device)
        self.accountant = PageAccountant(ecfg.page_tokens)
        be = self._make_inner()
        if ecfg.backend == "async":
            # lifecycle off the hot path: mkdir/rmdir/write/freeze/thaw/
            # lease ops run on the daemon thread in FIFO epochs, applied
            # at the flush() in step(); the step's enforcement goes
            # through the INNER backend's device view
            be = AsyncDaemonBackend(be)
        self.cg = AgentCgroup(be)
        # the engine's facade clock counts steps (set_time(step_no)), not
        # ms: PSI windows converted from ms to steps via step_ms
        self.cg.pressure_clock(
            step_quantum=1.0,
            windows=(PSI.AVG10_MS / ecfg.ctrl.step_ms,
                     PSI.AVG60_MS / ecfg.ctrl.step_ms))
        self._adaptive = (AdaptiveController(self.cg, ecfg.adaptive)
                          if ecfg.adaptive is not None else None)
        self._adaptive_epoch = None
        # pool_pages is per device group: each shard root is capped at
        # pool_pages in-step, so the aggregate the daemon reasons about
        # (root_usage sums every group) is pool_pages * n_shards
        self.pool_capacity = ecfg.pool_pages * getattr(be, "n_shards", 1)
        self._view = self.cg.device_view()
        self.log = EventLog()
        self.metrics = EngineMetrics()
        self.sessions: dict[str, Session] = {}
        self.waiting: list[str] = []
        self.slot_session: list[Optional[str]] = [None] * ecfg.max_slots
        self.step_no = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._host_gate = np.ones(ecfg.max_slots, bool)
        self._pending_gate = None
        self._ungate_step = None
        self._lease: dict[str, object] = {}      # sid -> open tool Lease
        self._tool_seq = 0
        self._prev_throttle = np.zeros(self.cg.backend.n_domains, np.int64)
        # ordered attach history (scope -> program, same-scope replaces in
        # place) so a backend rebuild replays the exact registry slots
        self._attachments: list = []
        self._last_snapshot: Optional[dict] = None
        # the step clock's and the admission records' rows (tracing.py)
        self.trace_id = tracing.engine_id()
        self._submit_row: dict[str, int] = {}
        # the step's device part as a graph, on a card; ``_graphed``
        # marks a step whose device work was a replay
        self._graph = None
        self._graphed = 0
        # an MoE model's step counts its held experts' assignments and
        # expert-product rows on the device (``decode_step``'s
        # ``counts``); the step copies them to the host behind its work,
        # and its first read waits for both
        self._moe = None
        if cfg.moe is not None:
            self._moe = {
                "dev": torch.zeros(2, dtype=torch.int64, device=self.device),
                "host": torch.zeros(2, dtype=torch.int64,
                                    pin_memory=self.device.type == "cuda")}
        if self.device.type == "cuda":
            self._hold_graph()

    def _make_inner(self):
        e = self.ecfg
        n_domains = 4 * e.max_slots + 8
        inner_kind = e.async_inner if e.backend == "async" else e.backend
        if inner_kind == "sharded":
            return ShardedTableBackend(e.pool_pages, n_domains=n_domains,
                                       cfg=e.ctrl, n_shards=e.n_shards,
                                       device=self.device)
        return DeviceTableBackend(e.pool_pages, n_domains=n_domains,
                                  cfg=e.ctrl, device=self.device)

    # ---------------------------------------------------- policy programs

    def attach_program(self, prog: PolicyProgram, path: str = "/") -> None:
        """Swap or compose in-step enforcement programs (BPF object
        load): the next step runs the new decision code.  A root attach
        replaces the whole registry; a subtree attach composes."""
        if path == "/":
            self._attachments = [("/", prog)]
        else:
            for i, (p, _) in enumerate(self._attachments):
                if p == path:
                    self._attachments[i] = (path, prog)
                    break
            else:
                self._attachments.append((path, prog))
        self.cg.attach(path, prog)
        self._view = self.cg.device_view()

    def update_params(self, path: str = "/", **kv) -> None:
        """Retune the live program mid-run (BPF map write)."""
        self.cg.update_params(path, **kv)

    # ------------------------------------------------------------ admission

    def submit(self, session: Session) -> None:
        self.sessions[session.sid] = session
        tenant_path = f"/{session.tenant}"
        if not self.cg.exists(tenant_path):
            self.cg.mkdir(tenant_path)
        self.waiting.append(session.sid)
        self._submit_row[session.sid] = tracing.record_submit(
            self.trace_id, session.priority, time.perf_counter_ns())

    def _try_admit(self) -> None:
        still = []
        for sid in self.waiting:
            s = self.sessions[sid]
            slot = self.caches.alloc_slot()
            if slot is None:
                still.append(sid)
                continue
            s.slot = slot
            low = 0
            if s.priority == D.HIGH:
                low = self.ecfg.pool_pages            # below_low protection
            high = (self.ecfg.session_high or {}).get(s.sid, D.UNLIMITED)
            s.dom_idx = self.cg.mkdir(s.domain, DomainSpec(
                priority=s.priority, low=low, high=high))
            s.t_admit = self.step_no
            self.slot_session[slot] = sid
            s.start()
            self.log.emit(self.step_no, Ev.ADMIT, s.domain)
            tracing.record_admit(self._submit_row.pop(sid),
                                 time.perf_counter_ns())
        self.waiting = still

    # --------------------------------------------------- tool-call domains

    def _sync_tool_domain(self, s: Session) -> None:
        """Ephemeral child domain per tool-result burst (bash-wrapper
        analogue); intent hints set its memory.high."""
        if not self.ecfg.use_tool_domains:
            return
        in_burst = bool(s.feed_queue) and s.length > len(s.prompt)
        has = s.sid in self._lease
        if in_burst and not has:
            self._tool_seq += 1
            high = D.UNLIMITED
            hint = None
            if self.ecfg.use_intent:
                table = self.ecfg.intent_high_pages or {
                    Hint.LOW: 4, Hint.MEDIUM: 10, Hint.HIGH: 24}
                hint = s.declared_hint()
                high = table.get(hint, table[Hint.MEDIUM])
            lease = self.cg.intent.declare(f"tool_{self._tool_seq}", hint,
                                           parent=s.domain,
                                           priority=s.priority, high=high)
            self._lease[s.sid] = lease
            s.dom_idx = self.cg.handle(lease.path)
        elif not in_burst and has:
            # context pages persist: lease close moves the residual
            # charge up to the session
            self._lease.pop(s.sid).close()
            s.dom_idx = self.cg.handle(s.domain)

    # -------------------------------------------------------------- daemon

    def _userspace_policy(self) -> None:
        """User-space throttle daemon: the same graduated-delay policy the
        in-kernel path applies, computed from telemetry polled every
        ``userspace_poll_steps`` and applied ``userspace_react_steps``
        late — the §4.2 responsiveness gap."""
        e = self.ecfg
        if self.step_no % e.userspace_poll_steps == 0:
            snap = self.cg.snapshot()
            usage, high, maxl = snap["usage"], snap["high"], snap["max"]
            parent = snap["parent"]
            progs = self.cg.programs
            ids = snap["prog_id"]
            decisions = {}
            for slot, sid in enumerate(self.slot_session):
                if sid is None:
                    continue
                s = self.sessions[sid]
                chain = [s.dom_idx]
                while parent[chain[-1]] >= 0:
                    chain.append(int(parent[chain[-1]]))
                over = max((usage[i] - high[i]) / max(high[i], 1)
                           for i in chain)
                hard = any(usage[i] >= maxl[i] for i in chain)
                if over > 0 or hard:
                    # the session's own program's delay curve, on its
                    # live param row — just polled late
                    pr = progs[min(int(ids[s.dom_idx]), len(progs) - 1)]
                    dly_ms = float(pr.delay_ms(
                        snap["params"][s.dom_idx], max(float(over), 0.0)))
                    dly = int(np.ceil(dly_ms / pr.step_ms)) or 1
                    decisions[slot] = (self.step_no + e.userspace_react_steps
                                       + dly)
            self._pending_gate = (self.step_no + e.userspace_react_steps,
                                  decisions)

    def _apply_pending_gate(self) -> None:
        pg = self._pending_gate
        if pg is not None and self.step_no >= pg[0]:
            if self._ungate_step is None:
                self._ungate_step = np.zeros(self.ecfg.max_slots)
            for slot, until in pg[1].items():
                self._ungate_step[slot] = max(self._ungate_step[slot], until)
                self.metrics.throttle_triggers += 1
            self._pending_gate = None
        if self._ungate_step is not None:
            self._host_gate = self._ungate_step <= self.step_no

    def _daemon(self) -> None:
        e = self.ecfg
        with span("engine.snapshot"):
            snap = self.cg.snapshot()
        # last known-good step-boundary snapshot: the rebuild-from-
        # snapshot path (poisoned async daemon) restores from here
        self._last_snapshot = snap
        root_usage = int(snap["root_usage"])
        self.metrics.peak_pool_pages = max(self.metrics.peak_pool_pages,
                                           root_usage)
        self.metrics.overshoot_pages = max(
            self.metrics.overshoot_pages, root_usage - self.pool_capacity)
        usage, high = snap["usage"], snap["high"]
        lim = high < D.UNLIMITED
        if lim.any():
            self.metrics.session_overshoot_pages = max(
                self.metrics.session_overshoot_pages,
                int((usage[lim] - high[lim]).max()))
        # freeze under extreme pressure (graceful degradation step 2)
        if e.use_freeze and root_usage > e.freeze_threshold * self.pool_capacity:
            cands = [self.sessions[sid] for sid in self.slot_session
                     if sid is not None
                     and self.sessions[sid].state is SState.RUNNING
                     and self.sessions[sid].priority == D.LOW]
            if cands:
                victim = max(cands, key=lambda s: s.pages)
                with span("engine.freeze"):
                    self._freeze(victim)
        else:
            frozen = [s for s in self.sessions.values()
                      if s.state is SState.FROZEN]
            if frozen and self.caches.n_free > 0:
                cand = min(frozen, key=lambda s: s.pages)
                if (root_usage + cand.pages
                        < e.thaw_threshold * self.pool_capacity):
                    with span("engine.thaw"):
                        self._thaw(cand)
        if self._adaptive is not None:
            # closed loop: poll every step boundary for synchronous
            # backends; for the async daemon, once per applied epoch:
            # pressure reads observe the state the flush just settled
            epoch = snap.get("epoch")
            if epoch is None or epoch != self._adaptive_epoch:
                self._adaptive_epoch = epoch
                self._adaptive.poll(float(self.step_no))
        with span("engine.admit"):
            self._try_admit()

    def _freeze(self, s: Session) -> None:
        if s.sid in self._lease:
            self._lease.pop(s.sid).close()     # residual moves to session
        self.caches.freeze_slot(s.sid, s.slot, pages=s.pages,
                                meta={"length": s.length},
                                now=self.step_no)
        self.slot_session[s.slot] = None
        # release pages (offloaded to host) + freeze the domain
        self.cg.uncharge(s.domain, s.pages)
        self.cg.freeze(s.domain)
        s.slot = -1
        s.state = SState.FROZEN
        s.n_freezes += 1
        self.metrics.n_freezes += 1
        self.log.emit(self.step_no, Ev.FREEZE, s.domain, pages=s.pages)

    def _thaw(self, s: Session) -> None:
        slot, meta = self.caches.thaw_slot(s.sid)
        self.cg.thaw(s.domain)
        self.cg.charge_unchecked(s.domain, s.pages)   # thaw re-charge
        s.slot = slot
        s.dom_idx = self.cg.handle(s.domain)
        self.slot_session[slot] = s.sid
        s.state = SState.RUNNING
        self.metrics.n_thaws += 1
        self.log.emit(self.step_no, Ev.THAW, s.domain)

    def _finish(self, s: Session) -> None:
        if s.sid in self._lease:
            self._lease.pop(s.sid).close()
        self.cg.uncharge(s.domain, s.pages)
        self.cg.rmdir(s.domain, transfer_residual=False)
        self.caches.free_slot(s.slot)
        self.slot_session[s.slot] = None
        s.slot = -1
        s.state = SState.DONE
        s.t_done = self.step_no
        self.log.emit(self.step_no, Ev.DONE, s.domain)

    def _evict(self, s: Session) -> None:
        """Last resort — the paper's triple-penalty path."""
        if s.sid in self._lease:
            self._lease.pop(s.sid).close()
        self.cg.uncharge(s.domain, s.pages)
        self.cg.rmdir(s.domain, transfer_residual=False)
        if s.slot >= 0:
            self.caches.free_slot(s.slot)
            self.slot_session[s.slot] = None
        s.state = SState.EVICTED
        s.t_done = self.step_no
        self.metrics.n_evictions += 1
        self.log.emit(self.step_no, Ev.EVICT, s.domain)

    # ------------------------------------------------- daemon-fault recovery

    def _rebuild_backend(self) -> None:
        """Survive a poisoned/wedged async daemon: drop the backend,
        stand up a fresh one from the last step-boundary ``snapshot()``,
        and reconcile anything newer than the snapshot from the engine's
        session state (which is authoritative)."""
        try:
            self.cg.backend.close(flush=False)
        except DaemonError:              # already poisoned
            pass
        inner = self._make_inner()
        for path, prog in self._attachments:
            inner.attach(path, prog)
        if self._last_snapshot is not None:
            inner.restore(self._last_snapshot)
        be = inner
        if self.ecfg.backend == "async":
            be = AsyncDaemonBackend(inner)
        self.cg.backend = be
        self.cg.set_time(self.step_no)
        self._reconcile_sessions()
        self._view = self.cg.device_view()
        self._prev_throttle = self._view.state["throttle_until"].reshape(
            -1).cpu().numpy().astype(np.int64)
        self.metrics.n_rebuilds += 1
        self.log.emit(self.step_no, Ev.REBUILD, "/")

    def _reconcile_sessions(self) -> None:
        """The snapshot is up to one step-boundary stale: admissions,
        freeze/thaw flips and charge drift since it was taken exist only
        in the Session objects; re-apply them to the rebuilt tree."""
        e = self.ecfg
        for s in self.sessions.values():
            if s.state in (SState.DONE, SState.EVICTED):
                continue
            tenant_path = f"/{s.tenant}"
            if not self.cg.exists(tenant_path):
                self.cg.mkdir(tenant_path)
            if s.state is SState.WAITING:
                continue
            if not self.cg.exists(s.domain):
                low = e.pool_pages if s.priority == D.HIGH else 0
                high = (e.session_high or {}).get(s.sid, D.UNLIMITED)
                self.cg.mkdir(s.domain, DomainSpec(
                    priority=s.priority, low=low, high=high))
            lease = self._lease.get(s.sid)
            if lease is not None and not self.cg.exists(lease.path):
                # the lease postdates the snapshot: drop it rather than
                # resurrect it; the next burst step re-declares
                self._lease.pop(s.sid)
                self.cg.intent._open.pop(lease.path, None)
                lease.closed = True
                lease = None
            path = lease.path if lease is not None else s.domain
            s.dom_idx = self.cg.handle(path)
            frozen = bool(self.cg.read(s.domain, "cgroup.freeze"))
            if s.state is SState.FROZEN and not frozen:
                self.cg.freeze(s.domain)
            elif s.state is not SState.FROZEN and frozen:
                self.cg.thaw(s.domain)
            want = 0 if s.state is SState.FROZEN else s.pages
            have = self.cg.usage(s.domain)
            if want > have:
                self.cg.charge_unchecked(path, want - have)
            elif have > want:
                self.cg.uncharge(path, have - want)

    # ----------------------------------------------------------------- step

    def _device_step(self, tokens, lengths, dom, amt, host_gate, inkernel):
        """The in-step program: the control part (schedule, charge or the
        stale host gate), then the device part (the gated merge, decode
        one token, sample), replayed as one graph on a card."""
        ctrl, granted, stalled = self._control(dom, amt, host_gate,
                                               inkernel)
        if self._graph is None:
            self._graphed = 0
            out = self._decode(tokens, lengths, granted)
        else:
            st = self._static
            st["tokens"].copy_(tokens)
            st["lengths"].copy_(lengths)
            st["gate"].copy_(granted)
            out, replayed = self._graph.run(lambda: self._decode(
                st["tokens"], st["lengths"], st["gate"]))
            self._graphed = int(replayed)
        if self.ecfg.temperature > 0:
            # the draw stays eager: the generator's sequence is unchanged
            out = self._pick(out, tokens, granted)
        return out, ctrl, granted, stalled

    def _control(self, dom, amt, host_gate, inkernel):
        """The control part, eager on every device: (the new control
        state, granted, stalled); a granted slot advances.  The charge
        takes the Python step number, writes a fresh state and may be
        tapped, so no graph holds it."""
        e = self.ecfg
        view = self._view
        ctrl = view.state
        if e.sched_slots is not None:
            # a slot the weighted scheduler defers does not advance this
            # step (its charge never reaches the memory controller)
            cost = (dom >= 0).to(torch.int32)
            ctrl, advance = view.schedule(ctrl, dom, cost, self.step_no,
                                          e.sched_slots)
            dom = torch.where(advance, dom, torch.full_like(dom, -1))
        if inkernel:
            # in-step enforcement: charge + gate inside the same step
            with span("engine.charge"):
                return view.charge(ctrl, dom, amt, self.step_no)
        # user-space baseline: the (stale) host gate decides; usage is
        # charged after the fact, so bursts overshoot the budget
        gate = host_gate & (dom >= 0)
        with span("engine.charge"):
            ctrl = view.account(ctrl, torch.where(
                gate, dom, torch.full_like(dom, -1)), amt)
        return ctrl, gate, (dom >= 0) & ~gate

    def _hold_graph(self) -> None:
        """Issue the step's device part as a ``StepGraph`` over static
        inputs (tokens, lengths, gate), which each step copies in."""
        m, dev = self.ecfg.max_slots, self.device
        self._static = {
            "tokens": torch.zeros(m, dtype=torch.int32, device=dev),
            "lengths": torch.zeros(m, dtype=torch.int32, device=dev),
            "gate": torch.zeros(m, dtype=torch.bool, device=dev)}
        self._graph = StepGraph()

    def _decode(self, tokens, lengths, gate):
        """The device part: decode one token of every slot, its state
        merged under the gate; the next tokens, or the logits where the
        draw is not greedy."""
        e = self.ecfg
        # The gated merge, in place: the reference's where() over the
        # whole state, without copying it.  decode_step writes only row
        # lengths[b] of each attention cache (GQA's k/v, MLA's ckv/krope);
        # those rows are saved before the write and put back for slots the
        # gate did not grant, the gate shaped to each leaf's rank.  A
        # recurrent layer (Mamba, mLSTM, sLSTM) rewrites its whole state:
        # decode_step writes its new value under the gate (``keep``), so
        # a denied slot keeps its state bit for bit.
        state = self.caches.state
        attn = [pos for kind, pos in zip(M.state_kinds(self.cfg), state)
                if kind == "attn"]
        bidx = torch.arange(e.max_slots, device=self.device)
        rows = lengths.long()
        # one range an attention layer, so that a profiler names the
        # gaps in each by it
        saved = []
        for pos in attn:
            with span("engine.merge_save"):
                saved.append({k: t[:, bidx, rows] for k, t in pos.items()})
        moe = self._moe
        if moe is not None:
            moe["dev"].zero_()
        logits, _ = M.decode_step(self.cfg, self.params, state, tokens,
                                  lengths, keep=gate,
                                  counts=None if moe is None else moe["dev"])
        for pos, old in zip(attn, saved):
            with span("engine.merge_restore"):
                for k, t in pos.items():
                    # a saved row is (group, slot, *rest) of a (group,
                    # slot, S_max, *rest) leaf
                    keep = gate.view(1, -1, *(1,) * (t.dim() - 3))
                    t[:, bidx, rows] = torch.where(keep, t[:, bidx, rows],
                                                   old[k])
        if e.temperature > 0:
            return logits
        return self._pick(logits, tokens, gate)

    def _pick(self, logits, tokens, gate):
        """The next token of each slot: sampled where the gate granted,
        the fed token kept where it did not."""
        with span("engine.sample"):
            nxt = sample(logits, self.generator,
                         temperature=self.ecfg.temperature)
            return torch.where(gate, nxt, tokens)

    def step(self) -> None:
        e = self.ecfg
        # the step clock: a boundary before each phase and after the
        # last, so that the phases tile the step (tracing.PHASES)
        clock = time.perf_counter_ns
        marks = [clock()]
        # epoch boundary: queued lifecycle ops (async backend) apply
        # here, before the step reads the control state, never between
        # the state read and the post-step commit.  A wedged/poisoned
        # daemon surfaces here as DaemonError; the engine rebuilds the
        # backend from the last step-boundary snapshot and the step
        # proceeds on the fresh control plane.
        with span("engine.flush"):
            try:
                self.cg.set_time(self.step_no)
                self.cg.flush()
            except DaemonError:
                self._rebuild_backend()
        marks.append(clock())
        if e.mode == "userspace":
            with span("engine.policy"):
                self._userspace_policy()
                self._apply_pending_gate()
        marks.append(clock())
        with span("engine.inputs"):
            # tokens/lengths/dom/amt
            inputs = np.zeros((4, e.max_slots), np.int32)
            inputs[2] = -1
            for slot, sid in enumerate(self.slot_session):
                if sid is None:
                    continue
                s = self.sessions[sid]
                if s.state is not SState.RUNNING:
                    continue
                self._sync_tool_domain(s)
                inputs[0, slot] = s.next_input() % self.cfg.padded_vocab
                inputs[1, slot] = min(s.length, e.s_max - 1)
                inputs[2, slot] = s.dom_idx
                inputs[3, slot] = self.accountant.crossing(s.length)
        marks.append(clock())
        with span("engine.issue"):
            dev_in = torch.from_numpy(inputs).to(self.device)
            host_gate = torch.from_numpy(self._host_gate).to(self.device)
            nxt, new_ctrl, granted, _ = self._device_step(
                dev_in[0], dev_in[1], dev_in[2], dev_in[3], host_gate,
                e.mode == "inkernel")
            if self._moe is not None:
                self._moe["host"].copy_(self._moe["dev"], non_blocking=True)
        marks.append(clock())
        with span("engine.readback"):
            self._view.commit(new_ctrl)
            # the first read waits for the device's queue
            nxt = nxt.cpu().numpy()
            granted = granted.cpu().numpy()
            tu = self._view.state["throttle_until"].reshape(-1)
            tu = tu.cpu().numpy().astype(np.int64)
        marks.append(clock())
        with span("engine.sessions"):
            # throttle-trigger accounting (memcg_bpf_ops delay counter)
            self.metrics.throttle_triggers += int(
                np.sum(tu > self._prev_throttle))
            self._prev_throttle = np.maximum(tu, self._prev_throttle)
            self._advance_sessions(nxt, granted, inputs[3])
        marks.append(clock())
        with span("engine.daemon"):
            self._daemon()
        marks.append(clock())
        tracing.record_step(self.trace_id, self.step_no, marks,
                            self._graphed,
                            () if self._moe is None
                            else self._moe["host"].tolist())
        self.step_no += 1
        self.metrics.steps = self.step_no

    def _advance_sessions(self, nxt, granted, amt) -> None:
        """After the device step: advance the granted slots' sessions
        and finish those done; graduated feedback, rollback or eviction
        for the stalled."""
        e = self.ecfg
        for slot, sid in enumerate(self.slot_session):
            if sid is None:
                continue
            s = self.sessions[sid]
            if s.state is not SState.RUNNING:
                continue
            if granted[slot]:
                if s.stall_started is not None:
                    s.alloc_latencies_steps.append(
                        self.step_no - s.stall_started)
                    s.stall_started = None
                elif amt[slot]:
                    s.alloc_latencies_steps.append(0)
                s.pages += int(amt[slot])
                s.advance(int(nxt[slot]))
                if s.finished or s.length >= e.s_max - 1:
                    self._finish(s)
            else:
                s.stall_steps += 1
                if s.stall_started is None:
                    s.stall_started = self.step_no
                stall = self.step_no - s.stall_started
                # graduated feedback: first shrink the pending append;
                # if the session is wedged against the pool wall, roll
                # the whole tool call back so its pages free and a
                # smaller retry fits
                if (stall > 0 and stall % e.feedback_patience_steps == 0
                        and s.feed_queue):
                    fb = self.cg.intent.feedback(
                        s.domain, "throttled", peak=s.pages,
                        limit=int(self.cg.read(self.cg.path_of(s.dom_idx),
                                               "memory.high")))
                    if (stall >= 2 * e.feedback_patience_steps
                            and s.burst_start_len >= 0):
                        freed = s.rollback_burst(scale=0.5)
                        if freed:
                            self.cg.uncharge(s.dom_idx, freed)
                        s.feedbacks.append(fb)
                        self.log.emit(self.step_no, Ev.FEEDBACK, s.domain,
                                      action="rollback", freed=freed)
                    else:
                        s.apply_feedback(fb, scale=0.5)
                        self.log.emit(self.step_no, Ev.FEEDBACK, s.domain,
                                      action="shrink")
                    self.metrics.n_feedbacks += 1
                elif stall > e.evict_patience_steps:
                    self._evict(s)

    def close(self) -> None:
        """Release backend resources: stops the async lifecycle daemon
        thread (a no-op for the synchronous backends)."""
        fn = getattr(self.cg.backend, "close", None)
        if fn is not None:
            fn()

    def run(self, max_steps: Optional[int] = None) -> EngineMetrics:
        limit = max_steps or self.ecfg.max_steps
        for _ in range(limit):
            if self.done():
                break
            self.step()
        return self.metrics

    def done(self) -> bool:
        """Every submitted session has finished or been evicted."""
        return not self.waiting and all(
            s.state in (SState.DONE, SState.EVICTED)
            for s in self.sessions.values())

    # -------------------------------------------------------------- report

    def report(self) -> dict:
        e = self.ecfg
        done = [s for s in self.sessions.values() if s.state is SState.DONE]
        evicted = [s for s in self.sessions.values()
                   if s.state is SState.EVICTED]
        lat_by_prio: dict[int, list] = {}
        for s in self.sessions.values():
            lat_by_prio.setdefault(s.priority, []).extend(
                x * e.ctrl.step_ms for x in s.alloc_latencies_steps)

        def pct(xs, p):
            if not xs:
                return 0.0
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]

        return {
            "mode": e.mode,
            "completed": len(done),
            "evicted": len(evicted),
            "survival": len(done) / max(len(self.sessions), 1),
            "steps": self.step_no,
            "high_p50_ms": pct(lat_by_prio.get(D.HIGH, []), 50),
            "high_p95_ms": pct(lat_by_prio.get(D.HIGH, []), 95),
            "low_p95_ms": pct(lat_by_prio.get(D.LOW, []), 95),
            "throttle_triggers": self.metrics.throttle_triggers,
            "freezes": self.metrics.n_freezes,
            "thaws": self.metrics.n_thaws,
            "feedbacks": self.metrics.n_feedbacks,
            "overshoot_pages": self.metrics.overshoot_pages,
            "session_overshoot_pages": self.metrics.session_overshoot_pages,
            "peak_pool_pages": self.metrics.peak_pool_pages,
        }
