"""The one traffic generator: a mix's data file in, the cell's requests
out, all from the seed.

Serving mixes (``"kind": "serve"``) are closed loops of agent clients
in tenants.  Each round gives every client one session; a round's
sessions are the same for every seed (their prompt lengths and phases
come from the mix's ``pool_seed``, through the frozen trace generator),
and the run's seed deals them to the clients in its own order and draws
their prompt tokens.  So every seed serves the same sizes, in another
order.  Prefill mixes (``"kind": "prefill"``) are a closed loop of one
client sending prompts of one length, drawn from the seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.harness import tracegen

PRIORITIES = {"LOW": 0, "NORMAL": 1, "HIGH": 2}


@dataclass(frozen=True)
class SessionSpec:
    """One agent session: its tenant, priority, prompt tokens and phases
    ``(gen_tokens, append_tokens, category)``."""
    sid: str
    client: int
    tenant: str
    priority: int
    prompt: tuple
    phases: tuple


def client_tenants(mix: dict) -> list:
    """``(tenant, priority)`` of each client, the tenants' clients spread
    evenly over the client order."""
    keyed = []
    for t in mix["tenants"]:
        n = t["clients"]
        keyed.extend(((j + 0.5) / n, t["name"], PRIORITIES[t["priority"]])
                     for j in range(n))
    keyed.sort()
    return [(name, prio) for _, name, prio in keyed]


def session_shapes(mix: dict) -> list:
    """The shape of every session of every round, from ``pool_seed``:
    ``(prompt length, phases)``, round by round, a client's worth each."""
    s = mix["sessions"]
    n = len(client_tenants(mix))
    rng = np.random.default_rng(s["pool_seed"])
    lo, hi = s["prompt_tokens"]
    out = []
    for k in range(s["rounds"] * n):
        model = s["models"][k % len(s["models"])]
        trace = tracegen.generate_task(f"agent-{k}", model,
                                       seed=s["pool_seed"] * 1000 + k,
                                       scale=s["scale"])
        phases = tracegen.session_phases(
            trace, tokens_per_mb=s["tokens_per_mb"],
            gen_per_call=s["gen_per_call"], max_phases=s["max_phases"])
        out.append((int(rng.integers(lo, hi + 1)), tuple(phases)))
    return out


def serving_sessions(mix: dict, seed: int, vocab: int) -> list:
    """Each client's queue of sessions: ``[[SessionSpec, ...], ...]``."""
    tenants = client_tenants(mix)
    n = len(tenants)
    shapes = session_shapes(mix)
    rng = np.random.default_rng(seed)
    queues = [[] for _ in range(n)]
    for r in range(mix["sessions"]["rounds"]):
        order = rng.permutation(n)
        for c in range(n):
            plen, phases = shapes[r * n + int(order[c])]
            tenant, prio = tenants[c]
            prompt = tuple(int(t) for t in rng.integers(2, vocab, plen))
            queues[c].append(SessionSpec(f"c{c}r{r}", c, tenant, prio,
                                         prompt, phases))
    return queues


def prefill_prompts(mix: dict, seed: int, vocab: int):
    """``(distinct_prompts, seq_len)`` int64 token ids, the prompts the
    client sends in turn."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (mix["distinct_prompts"], mix["seq_len"]),
                        dtype=np.int64)
