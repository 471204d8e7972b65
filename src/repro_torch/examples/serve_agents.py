"""End-to-end driver: multi-tenant agent serving with batched requests
(port of ``examples/serve_agents.py``).

Serves a reduced model to agent sessions derived from paper-calibrated
traces (each tool call's result floods the context, the KV-page analogue
of the paper's §3 memory bursts), under all three controller modes, and
prints a Fig-8-style comparison.  ``--full`` serves the arch at full
width instead (its dtype, weights from a seeded generator); the rows
follow session phases, not token values, so they equal the reduced
run's.  It runs on the card unless ``--device cpu`` is given.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_agents \\
         [--sessions 5] [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import domains as D
from repro_torch.core.controller import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.session import session_from_trace
from repro_torch.traces.generator import generate_task

MODES = {
    "nolimit": dict(mode="nolimit", use_freeze=False,
                    use_tool_domains=False, use_intent=False),
    "userspace": dict(mode="userspace", use_freeze=False,
                      use_tool_domains=False, use_intent=False),
    "agentcgroup": dict(mode="inkernel", use_freeze=True),
}
MAX_STEPS = 12000


def make_sessions(n: int, seed: int):
    out = []
    for i in range(n):
        trace = generate_task(f"agent-{i}", "glm" if i % 2 else "haiku",
                              seed=seed * 131 + i, scale=0.5)
        out.append(session_from_trace(
            sid=f"s{i}", tenant=f"tenant{i % 2}", trace=trace,
            priority=D.HIGH if i == 0 else D.LOW,
            tokens_per_mb=0.6, gen_per_call=12, max_phases=5))
    return out


def model_config(arch: str, full: bool):
    """The arch at full width in its dtype, or its reduced f32 miniature
    (the source's model)."""
    cfg = get_config(arch)
    return cfg if full else dataclasses.replace(reduced(cfg),
                                                dtype="float32")


def engine(cfg, params, mode: str, *, sessions: int, pool_pages: int,
           seed: int, device) -> Engine:
    """The engine of one mode with the sessions submitted, not stepped."""
    eng = Engine(cfg, params,
                 ecfg=EngineConfig(max_slots=4, s_max=512,
                                   pool_pages=pool_pages, page_tokens=16,
                                   **MODES[mode]),
                 seed=seed, device=device)
    for s in make_sessions(sessions, seed):
        eng.submit(s)
    return eng


def header() -> str:
    return (f"{'mode':12s} {'done':>5s} {'evict':>5s} {'overshoot':>9s} "
            f"{'throttles':>9s} {'freezes':>7s} {'feedbacks':>9s} "
            f"{'steps':>6s}")


def row(name: str, r: dict) -> str:
    return (f"{name:12s} {r['completed']:5d} {r['evicted']:5d} "
            f"{r['overshoot_pages']:9d} {r['throttle_triggers']:9d} "
            f"{r['freezes']:7d} {r['feedbacks']:9d} {r['steps']:6d}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--pool-pages", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the arch at full width (its dtype, seeded "
                         "random weights) instead of the reduced f32 model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None, params=None) -> dict:
    """Print the comparison; returns each mode's ``Engine.report()``.
    ``params`` (the model's weights on the device) is drawn from a
    generator seeded with ``--seed`` when not given."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args.arch, args.full)
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed),
            device=dev)
    width = "full width" if args.full else "reduced"
    print(f"serving {args.sessions} agent sessions on {args.arch} "
          f"({width}), pool={args.pool_pages} KV pages\n")
    print(header())
    out = {}
    for name in MODES:
        eng = engine(cfg, params, name, sessions=args.sessions,
                     pool_pages=args.pool_pages, seed=args.seed, device=dev)
        eng.run(MAX_STEPS)
        out[name] = eng.report()
        print(row(name, out[name]))
    print("\nAgentCgroup: everyone finishes, the pool is never "
          "overshot, and bursts are absorbed by throttle/freeze/feedback "
          "instead of evictions.")
    return out


if __name__ == "__main__":
    main()
