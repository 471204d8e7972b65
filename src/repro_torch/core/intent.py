"""Intent-driven bidirectional coordination (paper §5).

Upward (agent -> system): before each tool call the agent declares an
expected resource need (``AGENT_RESOURCE_HINT`` analogue).  Hints are
*advisory* — they set per-tool-call ``memory.high`` so a mis-declared
call throttles early instead of starving siblings; the feedback loop
corrects underestimates.

Downward (system -> agent): when a tool call is throttled beyond
recovery or killed, the controller emits a structured feedback record
(peak pages, limit, suggestion).  The agent model in the replay harness
reacts by *reconstructing its strategy* — retrying the call with reduced
scope (the paper's key exploitable property of agent workloads).

A pure-Python copy of ``repro/core/intent.py``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Hint(enum.Enum):
    LOW = "memory:low"
    MEDIUM = "memory:medium"
    HIGH = "memory:high"


# default per-hint soft limits, in pages (1 page ~ 1 MB in trace replay,
# calibrated to the paper's category statistics: file ops ~4.5 MB, git
# ~13.5 MB, pkg install P95 ~233 MB, test execution P95 ~518 MB).
HINT_HIGH_PAGES = {
    Hint.LOW: 32,
    Hint.MEDIUM: 256,
    Hint.HIGH: 768,
}

# tool-call semantic category -> hint an intent-aware agent would declare
CATEGORY_HINT = {
    "test": Hint.HIGH,
    "pip": Hint.MEDIUM,
    "python": Hint.MEDIUM,
    "build": Hint.HIGH,
    "file": Hint.LOW,
    "git": Hint.LOW,
    "read": Hint.LOW,
    "edit": Hint.LOW,
    "subagent": Hint.HIGH,
}


def parse_hint(s: Optional[str]) -> Optional[Hint]:
    if not s:
        return None
    try:
        return Hint(s)
    except ValueError:
        return None


def hint_to_high(hint: Optional[Hint], *, headroom: float = 1.5) -> int:
    """Map a declared hint to a per-tool-call ``memory.high`` (pages)."""
    if hint is None:
        return HINT_HIGH_PAGES[Hint.MEDIUM]
    return int(HINT_HIGH_PAGES[hint] * headroom)


@dataclass
class Feedback:
    """Structured downward feedback (stderr-injection analogue)."""
    tool_id: str
    reason: str                 # "throttled" | "oom" | "frozen"
    peak_pages: int
    limit_pages: int
    suggestion: str

    def render(self) -> str:
        return (f"[agentcgroup] tool {self.tool_id} {self.reason}: "
                f"peak {self.peak_pages} pages vs limit {self.limit_pages}. "
                f"{self.suggestion}")


def make_feedback(tool_id: str, reason: str, peak: int, limit: int) -> Feedback:
    if reason == "oom":
        sug = ("Reduce the scope of this command (e.g. run a subset of the "
               "test suite, or split the workload) and retry.")
    elif reason == "oom_kill":
        sug = ("This call was killed by its memcg hard limit; it will be "
               "retried at a negotiated higher limit if headroom allows.")
    elif reason == "throttled":
        sug = ("This call exceeded its declared memory hint; declare "
               "memory:high or reduce working-set size.")
    else:
        sug = "Session was frozen under memory pressure; it will resume."
    return Feedback(tool_id, reason, peak, limit, sug)


def feedback_from_oom(ev) -> Feedback:
    """Bridge a typed ``OomEvent`` (events.py) into the downward
    feedback record the replayed agent model consumes — the semantic
    half of the kill -> feedback -> retry loop."""
    return make_feedback(ev.path.rsplit("/", 1)[-1], "oom_kill",
                         ev.peak_pages, ev.limit_pages)


@dataclass
class AdaptiveAgentModel:
    """How the replayed agent reacts to downward feedback.

    ``scope_scale`` models strategy reconstruction: on OOM/throttle
    feedback, the retried tool call's memory burst shrinks by this
    factor (e.g. running half the test suite).  ``learns_hints``: after
    one correction the agent declares the right hint for that category.
    """
    scope_scale: float = 0.5
    max_retries: int = 2
    learns_hints: bool = True
    learned: dict = field(default_factory=dict)    # category -> Hint

    def on_feedback(self, category: str, fb: Feedback) -> dict:
        """Returns the retry adjustment for the failed tool call."""
        if self.learns_hints and fb.reason in ("throttled", "oom"):
            self.learned[category] = Hint.HIGH
        return {"scale": self.scope_scale if fb.reason == "oom" else 1.0,
                "hint": self.learned.get(category)}

    def hint_for(self, category: str, declared: Optional[Hint]) -> Optional[Hint]:
        return self.learned.get(category, declared)
