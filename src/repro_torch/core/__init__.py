"""AgentCgroup core, ported to PyTorch (``repro/core``).

  cgroup      — the cgroupfs-style facade, the host-tree and device-table
                backends and the intent channel
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
from repro_torch.core.domains import HIGH, LOW, NORMAL, UNLIMITED
from repro_torch.core.events import Ev, Event, EventLog
from repro_torch.core.freezer import FrozenStore
from repro_torch.core.intent import Feedback, Hint, hint_to_high
from repro_torch.core.progs import (ChainView, GraduatedThrottleProgram,
                                    PolicyProgram, Request,
                                    TokenBucketProgram, Verdict,
                                    charge_decision)
from repro_torch.core.sched import WeightedFairProgram

__all__ = [
    "AgentCgroup", "Backend", "ChargeTicket", "DeviceTableBackend",
    "DeviceView", "DomainSpec", "HostTreeBackend", "IntentChannel",
    "Lease", "HIGH", "LOW",
    "NORMAL", "UNLIMITED", "Ev", "Event", "EventLog", "FrozenStore",
    "Feedback", "Hint", "hint_to_high", "ChainView",
    "GraduatedThrottleProgram", "PolicyProgram", "Request",
    "TokenBucketProgram", "Verdict", "charge_decision",
    "WeightedFairProgram",
]
