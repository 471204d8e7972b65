"""AgentCgroup core, ported to PyTorch (``repro/core``).

  cgroup      — the cgroupfs-style facade, the host-tree and device-table
                backends and the intent channel
  sharded     — the device table as (n_shards, n) tensors, per-tenant
                placement, per-shard in-step enforcement
  daemon      — async lifecycle daemon backend: lifecycle ops off the
                enforcement hot path, applied in batched FIFO epochs
  faults      — deterministic, seeded fault injection around any backend
  progs       — attachable in-step policy programs
  adaptive    — the closed-loop pressure retuner
  escalation  — semantic OOM escalation and the waste ledger
  policy      — the trace-replay policies (Table 2 baselines + AgentCgroup)
  accounting  — replay-side PSI windows and allocation-latency stats
  controller  — device-resident state + in-step enforcement
  sched       — the hierarchical weighted step scheduler
  pressure    — PSI-style stall counters and averaging
  domains     — hierarchical resource domains (pure-Python reference)
  intent      — upward hints / downward feedback protocol
  freezer     — freeze/thaw with host-memory state offload
  events      — enforcement event log
"""
from repro_torch.core.cgroup import (AgentCgroup, Backend, ChargeTicket,
                                     DeviceTableBackend, DeviceView,
                                     DomainSpec, HostTreeBackend,
                                     IntentChannel, Lease)
from repro_torch.core.daemon import AsyncDaemonBackend, DaemonError
from repro_torch.core.domains import HIGH, LOW, NORMAL, UNLIMITED
from repro_torch.core.events import Ev, Event, EventLog
from repro_torch.core.freezer import FrozenStore
from repro_torch.core.intent import Feedback, Hint, hint_to_high
from repro_torch.core.progs import (ChainView, GraduatedThrottleProgram,
                                    PolicyProgram, Request,
                                    TokenBucketProgram, Verdict,
                                    charge_decision)
from repro_torch.core.faults import (FaultPlan, FaultyBackend,
                                     TransientBackendError)
from repro_torch.core.sched import WeightedFairProgram
from repro_torch.core.sharded import ShardedDeviceView, ShardedTableBackend

__all__ = [
    "AgentCgroup", "AsyncDaemonBackend", "Backend", "ChargeTicket",
    "DaemonError", "DeviceTableBackend", "DeviceView", "DomainSpec",
    "FaultPlan", "FaultyBackend", "HostTreeBackend", "IntentChannel",
    "Lease", "ShardedDeviceView", "ShardedTableBackend",
    "TransientBackendError", "HIGH", "LOW",
    "NORMAL", "UNLIMITED", "Ev", "Event", "EventLog", "FrozenStore",
    "Feedback", "Hint", "hint_to_high", "ChainView",
    "GraduatedThrottleProgram", "PolicyProgram", "Request",
    "TokenBucketProgram", "Verdict", "charge_decision",
    "WeightedFairProgram",
]
