"""A serving cell: the program's engine under a closed loop of agent
clients, stepped for a fixed wall-clock window.

Set-up builds the engine on the benchmark's weights, submits every
client's first session and steps until every slot holds a session and
each kernel of the step has run.  The window then steps the engine until
``seconds`` have passed; its rate is every token the engine advanced,
over all slots, divided by the wall time from the window's start to the
end of its last step.  A client whose session ends submits its next.

Around each step the harness records, from the sessions' public state,
which slots advanced, the token each fed and the token each served, and
taps the step's in-step charge (``DeviceView.charge``) to keep the
table it read, the slots' requests and what it decided.  After the
window these records are judged against the plain references
(``checks.py``); nothing of this enters the program.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from portbench.harness import traffic

TAP_IN = ("parent", "high", "max", "low", "frozen", "priority", "usage",
          "peak", "throttle_until", "prog", "mem_stall")
TAP_OUT = ("usage", "peak", "throttle_until", "prog", "mem_stall")


class ChargeTap:
    """Stands in for ``view.charge``: calls it and keeps copies of the
    table it read, the slots' requests, the columns it wrote and the
    slots it granted or stalled (device copies, read after the
    window)."""

    def __init__(self, view):
        self._charge = view.charge
        self.calls = []
        view.charge = self

    def __call__(self, state, dom, amt, step):
        pre = {k: state[k].clone() for k in TAP_IN}
        new, granted, stalled = self._charge(state, dom, amt, step)
        self.calls.append({
            "step": int(step), "dom": dom.clone(), "amt": amt.clone(),
            "pre": pre, "post": {k: new[k].clone() for k in TAP_OUT},
            "granted": granted.clone(), "stalled": stalled.clone()})
        return new, granted, stalled

    def host(self) -> list:
        """The recorded calls as numpy arrays."""
        def np_(t):
            return t.cpu().numpy()
        return [{"step": c["step"], "dom": np_(c["dom"]),
                 "amt": np_(c["amt"]),
                 "pre": {k: np_(v) for k, v in c["pre"].items()},
                 "post": {k: np_(v) for k, v in c["post"].items()},
                 "granted": np_(c["granted"]),
                 "stalled": np_(c["stalled"])} for c in self.calls]


@dataclasses.dataclass
class SessionLog:
    """What the harness saw of one session: the token fed at each cache
    position (the last write wins after a rollback) and each token
    served with the position whose logits chose it."""
    sid: str
    priority: int
    fed: dict = dataclasses.field(default_factory=dict)
    served: list = dataclasses.field(default_factory=list)
    grant_times: list = dataclasses.field(default_factory=list)


def build_engine(prog, model_cfg, params, mix: dict, seed: int, device):
    """The program's engine for the mix's settings."""
    E = prog["engine"]
    e = dict(mix["engine"])
    ecfg = E.EngineConfig(**e)
    return E.Engine(model_cfg, params, ecfg=ecfg, seed=seed, device=device)


def make_session(prog, spec: traffic.SessionSpec):
    S = prog["session"]
    return S.Session(
        sid=spec.sid, tenant=spec.tenant, priority=spec.priority,
        prompt=list(spec.prompt),
        phases=[S.Phase(g, a, c) for g, a, c in spec.phases])


class ServeLoop:
    """The closed loop around one engine, with the harness's records."""

    def __init__(self, prog, eng, queues: list, vocab: int, sync):
        self.prog = prog
        self.eng = eng
        self.queues = [list(q) for q in queues]
        self.vocab = vocab
        self.sync = sync
        self.logs: dict = {}
        self.live: dict = {}          # client -> Session
        self.submitted = 0
        self.tap = ChargeTap(eng._view)
        for c in range(len(self.queues)):
            self._submit(c)

    def _submit(self, c: int) -> None:
        if not self.queues[c]:
            return
        spec = self.queues[c].pop(0)
        s = make_session(self.prog, spec)
        self.logs[s.sid] = SessionLog(s.sid, s.priority)
        self.live[c] = s
        self.eng.submit(s)
        self.submitted += 1

    def step(self) -> dict:
        """One engine step and what it did: the slots that asked, the
        tokens advanced and the keys they attended, the cache position
        of every slot (0 where none runs), the wall time at its end."""
        eng = self.eng
        running = self.prog["session"].SState.RUNNING
        pre = []
        lengths = np.zeros(eng.ecfg.max_slots, np.int64)
        for slot, sid in enumerate(eng.slot_session):
            if sid is None:
                continue
            s = eng.sessions[sid]
            if s.state is not running:
                continue
            pos = min(s.length, eng.ecfg.s_max - 1)
            lengths[slot] = pos
            pre.append((s, pos, s.next_input() % self.vocab,
                        len(s.feed_queue)))
        eng.step()
        self.sync()
        t = time.perf_counter()
        granted = keys = 0
        for s, pos, fed, queued in pre:
            log = self.logs[s.sid]
            if s.length == pos + 1:
                granted += 1
                keys += pos + 1
                log.fed[pos] = fed
                log.grant_times.append(t)
                if queued <= 1:
                    log.served.append((pos, int(s.cur_token)))
            elif s.length < pos:
                # a rolled-back tool call: later positions are rewritten
                log.served = [x for x in log.served if x[0] < s.length]
        done = (self.prog["session"].SState.DONE,
                self.prog["session"].SState.EVICTED)
        for c, s in list(self.live.items()):
            if s.state in done:
                del self.live[c]
                self._submit(c)
        return {"t": t, "asked": len(pre), "granted": granted,
                "granted_keys": keys, "lengths": lengths}


def window(loop: ServeLoop, seconds: float) -> dict:
    """Step until ``seconds`` have passed; the steps and the window."""
    steps = []
    loop.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        steps.append(loop.step())
    return {"t0": t0, "t1": steps[-1]["t"], "steps": steps}


def table_accounting(loop: ServeLoop) -> dict:
    """The control table the window leaves, against the sessions'
    lengths: a running session's domain holds ceil(length / page)
    pages, a frozen one none, a tenant the sum of its sessions', the
    root the sum of its tenants'.  Returns the domains that differ."""
    eng = loop.eng
    SState = loop.prog["session"].SState
    usage = eng.cg.device_view().state["usage"].cpu().numpy()
    page = eng.ecfg.page_tokens
    want_tenant: dict = {}
    bad = []
    for s in eng.sessions.values():
        if s.state in (SState.DONE, SState.EVICTED, SState.WAITING):
            continue
        pages = 0 if s.state is SState.FROZEN else math.ceil(s.length / page)
        want_tenant[s.tenant] = want_tenant.get(s.tenant, 0) + pages
        got = int(usage[eng.cg.handle(s.domain)])
        if got != pages:
            bad.append((s.domain, got, pages))
    for tenant, pages in want_tenant.items():
        got = int(usage[eng.cg.handle(f"/{tenant}")])
        if got != pages:
            bad.append((f"/{tenant}", got, pages))
    root = sum(want_tenant.values())
    if int(usage[0]) != root:
        bad.append(("/", int(usage[0]), root))
    return {"domains": len(want_tenant) + 1 + sum(
        1 for s in eng.sessions.values()
        if s.state in (SState.RUNNING, SState.FROZEN)), "mismatched": bad}
