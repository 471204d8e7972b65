r"""Agent sessions: the serving engine's unit of tenancy.

A session models one sandboxed agent: a prompt, then an alternating
reason/act loop in which each tool call's *result* is appended to the
context as a burst of tokens (the KV-page analogue of the paper's
tool-call memory bursts; a sub-agent fork appends an especially large
result).  Scripts can be built directly or derived from a §3 trace.

State machine: WAITING -> RUNNING <-> (THROTTLED | FROZEN) -> DONE
                                   \-> EVICTED (last resort)

Port of ``repro/serving/session.py`` (pure Python).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import domains as D
from repro_torch.core.intent import CATEGORY_HINT, Hint
from repro_torch.traces.schema import TaskTrace


class SState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FROZEN = "frozen"
    DONE = "done"
    EVICTED = "evicted"


@dataclass
class Phase:
    """One reason/act cycle: generate ``gen_tokens``, then a tool call
    whose result appends ``append_tokens`` to the context."""
    gen_tokens: int
    append_tokens: int = 0
    category: str = "python"
    hint: Optional[Hint] = None


@dataclass
class Session:
    sid: str
    tenant: str
    priority: int = D.NORMAL
    prompt: list = field(default_factory=list)       # token ids
    phases: list = field(default_factory=list)       # list[Phase]
    state: SState = SState.WAITING
    slot: int = -1
    dom_idx: int = -1
    length: int = 0                  # tokens in cache
    pages: int = 0                   # pages charged
    # progress
    phase_idx: int = 0
    phase_gen_left: int = 0
    feed_queue: list = field(default_factory=list)   # tokens to force-feed
    out_tokens: list = field(default_factory=list)
    cur_token: int = 1
    # metrics
    t_admit: int = 0                 # engine step of admission
    t_done: int = 0
    stall_steps: int = 0
    stall_started: Optional[int] = None
    alloc_latencies_steps: list = field(default_factory=list)
    n_freezes: int = 0
    feedbacks: list = field(default_factory=list)
    # snapshot at the start of the current tool-result burst, so the
    # engine can roll the call back (subprocess-kill + retry analogue)
    burst_start_len: int = -1
    burst_start_pages: int = 0
    burst_start_token: int = 1
    burst_total: int = 0
    n_rollbacks: int = 0

    @property
    def domain(self) -> str:
        return f"/{self.tenant}/{self.sid}"

    def start(self) -> None:
        self.feed_queue = list(self.prompt)
        if self.phases:
            self.phase_gen_left = self.phases[0].gen_tokens
        self.state = SState.RUNNING

    # ---------------------------------------------------------- stepping

    def next_input(self) -> int:
        """Token to feed this step (prompt/tool-result chunk, or the
        last sampled token during generation)."""
        if self.feed_queue:
            return self.feed_queue[0]
        return self.cur_token

    def advance(self, sampled: int) -> None:
        """Called when the engine step granted this slot's token."""
        self.length += 1
        if self.feed_queue:
            self.feed_queue.pop(0)       # consumed one forced token
            if not self.feed_queue:
                self.cur_token = sampled
            return
        self.cur_token = sampled
        self.out_tokens.append(sampled)
        if self.phase_idx < len(self.phases):
            ph = self.phases[self.phase_idx]
            self.phase_gen_left -= 1
            if self.phase_gen_left <= 0:
                # the tool call returns: its result floods the context
                if ph.append_tokens:
                    self.burst_start_len = self.length
                    self.burst_start_pages = self.pages
                    self.burst_start_token = self.cur_token
                    self.burst_total = ph.append_tokens
                    self.feed_queue.extend(
                        (i % 1000) + 2 for i in range(ph.append_tokens))
                self.phase_idx += 1
                if self.phase_idx < len(self.phases):
                    self.phase_gen_left = self.phases[self.phase_idx].gen_tokens

    @property
    def finished(self) -> bool:
        return (self.phase_idx >= len(self.phases) and not self.feed_queue)

    def current_phase(self) -> Optional[Phase]:
        if self.phase_idx < len(self.phases):
            return self.phases[self.phase_idx]
        return None

    def declared_hint(self) -> Optional[Hint]:
        ph = self.current_phase()
        if ph is None:
            return None
        return ph.hint or CATEGORY_HINT.get(ph.category)

    # ----------------------------------------------- feedback adaptation

    def apply_feedback(self, fb, scale: float) -> None:
        """Strategy reconstruction: shrink the pending context append."""
        self.feedbacks.append(fb)
        if self.feed_queue:
            keep = max(1, int(len(self.feed_queue) * scale))
            del self.feed_queue[keep:]

    def rollback_burst(self, scale: float) -> int:
        """Subprocess-kill analogue: revert to the pre-tool-call context,
        releasing its pages, and queue a scaled-down retry of the result.
        Returns pages freed (engine uncharges them)."""
        if self.burst_start_len < 0:
            return 0
        freed = self.pages - self.burst_start_pages
        self.length = self.burst_start_len
        self.pages = self.burst_start_pages
        self.cur_token = self.burst_start_token
        self.burst_total = max(1, int(self.burst_total * scale))
        self.feed_queue = [(i % 1000) + 2 for i in range(self.burst_total)]
        self.n_rollbacks += 1
        return max(freed, 0)


def session_from_trace(sid: str, tenant: str, trace: TaskTrace, *,
                       priority: int = D.NORMAL, tokens_per_mb: float = 4.0,
                       gen_per_call: int = 24, max_phases: int = 12,
                       prompt_tokens: int = 48) -> Session:
    """Map a §3 trace to a serving session: each tool call becomes a
    phase whose appended result size scales with the call's burst."""
    phases = []
    for c in sorted(trace.tool_calls, key=lambda c: c.t_start_s)[:max_phases]:
        phases.append(Phase(
            gen_tokens=gen_per_call,
            append_tokens=max(4, int(c.peak_mb * tokens_per_mb)),
            category=c.category))
    return Session(sid=sid, tenant=tenant, priority=priority,
                   prompt=[(i % 997) + 2 for i in range(prompt_tokens)],
                   phases=phases)
