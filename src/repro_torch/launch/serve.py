"""Multi-tenant serving driver (port of ``repro/launch/serve.py``).

Builds the model, derives agent sessions from §3-calibrated traces, and
runs the continuous-batching engine in one of the controller modes:

  inkernel   — AgentCgroup: in-step enforcement + tool-call domains +
               intent hints + freeze/thaw + feedback  (the paper's system)
  userspace  — poll/react daemon gating (responsiveness baseline)
  nolimit    — accounting only (no isolation baseline)

``--arch`` takes every registered decoder the engine serves (GQA and
MLA attention, Mamba-2 hybrid, mLSTM/sLSTM).  It runs on the card
unless ``--device cpu`` is given.  ``--reduced`` serves the same-family
miniature in f32 (the reference driver's model); otherwise the
full-width model serves in its dtype with random weights from a seeded
generator, at full depth unless ``--layers`` cuts it (for a model whose
weights one card cannot hold).  The report follows session phases, not
token values, so a full-width run's report equals the reduced one's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --mode inkernel --sessions 4 --pool-pages 48
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import domains as D
from repro_torch.core.controller import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.session import session_from_trace
from repro_torch.traces.generator import generate_task


def default_sessions(n: int, seed: int = 0) -> list:
    """1 HIGH-priority session + (n-1) LOW sessions from generated traces."""
    out = []
    for i in range(n):
        trace = generate_task(f"agent-{i}", "glm" if i % 2 else "haiku",
                              seed=seed * 1000 + i, scale=0.6)
        out.append(session_from_trace(
            sid=f"s{i}", tenant="tenant0", trace=trace,
            priority=D.HIGH if i == 0 else D.LOW,
            tokens_per_mb=0.2, gen_per_call=16, max_phases=6))
    return out


def serve(args, after_step=None, **engine) -> tuple:
    """Build the model and the engine, submit the sessions and step until
    every one is done or ``--max-steps``; returns the engine and the
    step timing (host clock, ending in a synchronize on the card).
    ``after_step(engine)``, when given, runs after each step, outside
    the timed span (a caller's check of the live state); ``engine``
    holds further ``EngineConfig`` fields (the control plane's
    ``backend``, ``async_inner``, ``n_shards``)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if args.layers:
        if args.layers % cfg.group_size:
            raise ValueError(f"--layers {args.layers} is no multiple of "
                             f"{cfg.name}'s group of {cfg.group_size}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    ecfg = EngineConfig(
        max_slots=args.slots, s_max=args.s_max, pool_pages=args.pool_pages,
        page_tokens=args.page_tokens, mode=args.mode,
        use_freeze=(args.mode == "inkernel"),
        use_tool_domains=(args.mode == "inkernel"),
        use_intent=(args.mode == "inkernel"),
        session_high=(json.loads(args.session_high) if args.session_high
                      else None),
        **engine,
    )
    eng = Engine(cfg, params, ecfg=ecfg, seed=args.seed, device=dev)
    sessions = default_sessions(args.sessions, seed=args.seed)
    for s in sessions:
        eng.submit(s)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step_ms, tokens = [], 0
    sync()
    for _ in range(args.max_steps):
        if eng.done():
            break
        before = sum(s.length for s in sessions)
        t = time.perf_counter()
        eng.step()
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        tokens += max(0, sum(s.length for s in sessions) - before)
        if after_step is not None:
            after_step(eng)
    total_s = sum(step_ms) / 1e3
    timing = {"steps": len(step_ms), "tokens": tokens,
              "step_ms_p50": statistics.median(step_ms) if step_ms else 0.0,
              "step_ms_p95": (float(np.percentile(step_ms, 95))
                              if step_ms else 0.0),
              "tokens_per_s": tokens / total_s if total_s else 0.0}
    return eng, timing


def run(args) -> dict:
    eng, _ = serve(args)
    report = eng.report()
    print(json.dumps(report, indent=1), flush=True)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (a multiple of "
                         "the layer group); 0 keeps the config's")
    ap.add_argument("--mode", default="inkernel",
                    choices=["inkernel", "userspace", "nolimit"])
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=512)
    ap.add_argument("--pool-pages", type=int, default=48)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--session-high", default=None,
                    help='JSON dict sid->pages, e.g. {"s1": 12}')
    ap.add_argument("--max-steps", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced f32 model instead of full width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
