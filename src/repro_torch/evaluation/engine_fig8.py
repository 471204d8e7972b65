"""Fig 8 on the LIVE serving engine (beyond-paper): three concurrent
agent sessions on a real (reduced) model with KV-page budgets, comparing
no-isolation / user-space daemon / in-step AgentCgroup enforcement.

Port of ``benchmarks/engine_fig8.py`` as a module of the port: the same
sessions, engine settings and printed table, each mode's
``Engine.report()`` returned.  ``--full`` serves llama3.2-3b at its full
width (28 layers, d 3072, 24/8 heads, bf16, weights from a seeded
generator) instead of the reduced f32 model; the reports follow session
phases, not token values, so they equal the reduced run's.  Runs on the
card unless ``--device cpu`` is given.

Run: PYTHONPATH=src python -m repro_torch.evaluation.engine_fig8 \\
         [--full] [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import domains as D
from repro_torch.core.controller import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.session import Phase, Session

ARCH = "llama3.2-3b"
COMMON = dict(max_slots=4, s_max=384, pool_pages=40, page_tokens=16)
SESSION_HIGH = {"lo1": 12, "lo2": 12}


def model(device, full: bool = False, params=None):
    """``(cfg, params)``: llama3.2-3b reduced in f32 (the source's model)
    or at full width; ``params`` drawn from a generator seeded with 0 on
    ``device`` when not given."""
    cfg = get_config(ARCH)
    if not full:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
    return cfg, params


def sessions():
    hi = Session(sid="hi", tenant="t", priority=D.HIGH,
                 prompt=list(range(2, 34)),
                 phases=[Phase(8, 96, "test"), Phase(8, 64, "git"),
                         Phase(12, 0)])
    lows = [Session(sid=f"lo{i}", tenant="t", priority=D.LOW,
                    prompt=list(range(2, 26)),
                    phases=[Phase(8, 160, "test"), Phase(8, 96, "test"),
                            Phase(8, 0)]) for i in (1, 2)]
    return [hi] + lows


def run(device="cuda", full: bool = False, params=None):
    dev = resolve_device(device)
    cfg, params = model(dev, full, params)
    scens = {
        "nolimit": EngineConfig(**COMMON, mode="nolimit", use_freeze=False,
                                use_tool_domains=False, use_intent=False),
        "userspace": EngineConfig(**COMMON, mode="userspace",
                                  use_freeze=False, use_tool_domains=False,
                                  use_intent=False,
                                  session_high=SESSION_HIGH),
        "agentcgroup": EngineConfig(**COMMON, mode="inkernel",
                                    use_freeze=True,
                                    session_high=SESSION_HIGH),
    }
    print("\n== live-engine multi-tenant serving (beyond-paper Fig 8) ==")
    print(f"{'mode':12s} {'survival':>8s} {'evict':>6s} {'pool_over':>9s} "
          f"{'sess_over':>9s} {'throttles':>9s} {'freezes':>7s} "
          f"{'lowP95ms':>8s} {'steps':>6s}")
    out = {}
    for name, ecfg in scens.items():
        eng = Engine(cfg, params, ecfg=ecfg, seed=0, device=dev)
        for s in sessions():
            eng.submit(s)
        eng.run(8000)
        r = eng.report()
        out[name] = r
        print(f"{name:12s} {r['survival']:8.2f} {r['evicted']:6d} "
              f"{r['overshoot_pages']:9d} {r['session_overshoot_pages']:9d} "
              f"{r['throttle_triggers']:9d} {r['freezes']:7d} "
              f"{r['low_p95_ms']:8.1f} {r['steps']:6d}")
    return out


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="serve llama3.2-3b at full width (bf16, seeded "
                         "random weights) instead of the reduced f32 model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, full=args.full, params=params)


if __name__ == "__main__":
    main()
