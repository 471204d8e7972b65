"""One run of one cell: set-up, the timed window, the traced block, the
comparison with the plain reference, the result line.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the configuration's file, ``portbench/traffic/
<mix>.json``, ``portbench/checks/<workload>.json`` (the limits) and, for
each per-layer metric, ``portbench/metrics/<metric>.py`` (a reader with
``read(run) -> float | None``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(RuntimeError):
    """A cell that cannot run here: no card, a missing file."""


def process_start() -> float:
    """The wall-clock time this process started, from ``/proc`` (the
    module's import time where that cannot be read)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def process_env(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths; keep libraries from loading JAX; one host thread for torch's
    own CPU work, so that the process's load is its one stepping thread
    (the card's host shares its cores)."""
    build = root / "build"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[key] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[key] = "1"


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's,
    Flax's or the JAX package's, compared whole: ``repro_torch`` is not
    ``repro``."""
    tops = {m.split(".")[0] for m in list(
        sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


# ------------------------------------------------------------- the cell


def load_cell(root: Path, workload: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "checks"
                         / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in names)]
    return {"name": workload, "cell": cell, "cfg": cfg, "mix": mix,
            "limits": limits, "end_to_end": e2e, "per_layer": layer,
            "root": root}


def reader(root: Path, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program() -> dict:
    """The modules of the program under test."""
    from repro_torch import kernels
    from repro_torch.configs import base
    from repro_torch.models import model
    from repro_torch.serving import engine, session
    from repro_torch import perf
    return {"engine": engine, "session": session, "model": model,
            "base": base, "kernels": kernels, "perf": perf}


def model_config(prog: dict, cfg: dict):
    """The program's ``ModelConfig`` for the configuration's file."""
    base = prog["base"]
    fields = {f.name for f in dataclasses.fields(base.ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    if cfg.get("moe"):
        kw["moe"] = base.MoEConfig(**cfg["moe"])
    if cfg.get("ssm"):
        kw["ssm"] = base.SSMConfig(**cfg["ssm"])
    return base.ModelConfig(**kw)


def reference(cfg: dict):
    name = cfg["reference"]
    return importlib.import_module(f"portbench.reference.{name}")


# ----------------------------------------------------------- the drivers


def _parts(parts: list) -> dict:
    """Seconds of each part of set-up after the program's import."""
    return {name: round(t - parts[i][1], 3)
            for i, (name, t) in enumerate(parts[1:])}


def _free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_serve(ctx: dict, prog: dict, seed: int, seconds: float,
              trace_calls: int, device) -> dict:
    import torch

    from portbench.harness import checks, serve, traffic, weights
    from portbench.harness.trace import traced

    cfg, mix = ctx["cfg"], ctx["mix"]
    mcfg = model_config(prog, cfg)
    sync = ctx["sync"]
    parts = [("start", time.perf_counter())]
    params = weights.make_params(prog["model"].param_leaves(mcfg),
                                 cfg["init"], mcfg.dtype, seed, device)
    sync()
    parts.append(("weights", time.perf_counter()))
    eng = serve.build_engine(prog, mcfg, params, mix, seed, device)
    queues = traffic.serving_sessions(mix, seed, mcfg.vocab)
    loop = serve.ServeLoop(prog, eng, queues, mcfg.padded_vocab, sync)
    parts.append(("engine", time.perf_counter()))
    for _ in range(mix["warm_steps"]):
        loop.step()
    parts.append(("warm", time.perf_counter()))
    win = serve.window(loop, seconds)
    table = serve.table_accounting(loop)
    tr = None
    if trace_calls:
        tr = traced(loop.step, trace_calls, sync,
                    prog["kernels"].launch_counts)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0
    calls = loop.tap.host()
    logs = loop.logs
    evicted = eng.metrics.n_evictions
    step_ms = eng.ecfg.ctrl.step_ms
    pool = eng.ecfg.pool_pages
    submitted = loop.submitted
    del loop, eng
    _free()

    tokens = sum(s["granted"] for s in win["steps"])
    wall = win["t1"] - win["t0"]
    run = {"kind": "serve", "cfg": cfg, "mix": mix, "t0": win["t0"],
           "t1": win["t1"], "window_s": wall, "steps": win["steps"],
           "logs": logs, "trace": tr,
           "charge_calls": calls[len(calls) - trace_calls:] if tr else []}
    lim = ctx["limits"]["limits"]
    numbers = {}
    bad, root = checks.charge_mismatches(calls, step_ms)
    numbers["charge_mismatch_steps"] = bad
    numbers["pool_overshoot_pages"] = root - pool
    numbers["table_mismatch_domains"] = len(table["mismatched"])
    sample = checks.sample_sessions(
        logs, seed, ctx["limits"]["served_tokens"],
        ctx["limits"]["max_sessions"])
    if sample:
        seqs, want, tok = checks.session_inputs(sample, device)
        ref = reference(cfg).logits_at(cfg, params, seqs, want)
        numbers["served_gap"] = checks.served_gap(ref, tok)
        if ctx.get("control"):
            low = reference(cfg).logits_at(cfg, params, seqs, want,
                                           precision="float8")
            numbers["control_gap"] = checks.first_choice_gap(ref, low)
        numbers["served_tokens_checked"] = sum(len(w) for w in want)
    numbers["charge_steps_checked"] = len(calls)
    del params
    _free()
    return {"run": run, "numbers": numbers, "limits": lim, "peak": peak,
            "attempted": submitted, "failed": evicted,
            "e2e": {"served_tokens_per_s": tokens / wall},
            "notes": {"table_mismatched": table["mismatched"][:5],
                      "steps": len(win["steps"]), "tokens": tokens,
                      "setup_parts_s": _parts(parts)}}


def run_prefill(ctx: dict, prog: dict, seed: int, seconds: float,
                trace_calls: int, device) -> dict:
    import numpy as np
    import torch

    from portbench.harness import checks, traffic, weights
    from portbench.harness.trace import traced

    cfg, mix = ctx["cfg"], ctx["mix"]
    mcfg = model_config(prog, cfg)
    perf = prog["perf"].PerfConfig(**cfg.get("perf", {}))
    sync = ctx["sync"]
    M = prog["model"]
    parts = [("start", time.perf_counter())]
    params = weights.make_params(M.param_leaves(mcfg), cfg["init"],
                                 mcfg.dtype, seed, device)
    sync()
    parts.append(("weights", time.perf_counter()))
    prompts = torch.as_tensor(traffic.prefill_prompts(mix, seed, mcfg.vocab),
                              device=device)
    rng = np.random.default_rng(seed)
    S = mix["seq_len"]
    k = ctx["limits"]["positions"]
    pos = np.sort(np.concatenate([rng.choice(S - 1, k - 1, replace=False),
                                  [S - 1]]))
    pos_t = torch.as_tensor(pos, device=device)
    n = prompts.shape[0]

    def one(i):
        with torch.inference_mode():
            logits, _ = M.forward(mcfg, params,
                                  {"tokens": prompts[i % n][None]}, perf=perf)
            return logits[0, pos_t].clone()

    for i in range(mix["warm"]):
        one(i)
    sync()
    parts.append(("warm", time.perf_counter()))
    kept, times = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        kept.append(one(len(kept)))
        sync()
        times.append(time.perf_counter())
    win = {"t0": t0, "t1": times[-1], "steps": [{"t": t} for t in times]}
    tr = None
    if trace_calls:
        tr = traced(lambda: one(0), trace_calls, sync,
                    prog["kernels"].launch_counts)
        tr["outs"] = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0
    _free()
    done = len(kept)
    wall = win["t1"] - win["t0"]
    run = {"kind": "prefill", "cfg": cfg, "mix": mix, "t0": t0,
           "t1": win["t1"], "window_s": wall, "steps": win["steps"],
           "prefills": done, "trace": tr}
    numbers = {}
    picks = rng.choice(done, min(ctx["limits"]["prefills"], done),
                       replace=False)
    ref_mod = reference(cfg)
    got, want, low = [], [], []
    for j in picks:
        seq = prompts[int(j) % n]
        want += ref_mod.logits_at(cfg, params, [seq], [pos_t])
        got.append(kept[int(j)])
        if ctx.get("control"):
            low += ref_mod.logits_at(cfg, params, [seq], [pos_t],
                                     precision="float8")
    tol = ctx["limits"]["position_tol"]
    err = checks.position_errors(got, want)
    numbers["off_positions_share"] = checks.off_share(err, tol)
    numbers["logits_rel_err"] = checks.rel_err(got, want)
    numbers["position_err_p50"] = float(err.median())
    if ctx.get("control"):
        low_err = checks.position_errors(low, want)
        numbers["control_off_positions_share"] = checks.off_share(low_err,
                                                                 tol)
        numbers["control_rel_err"] = checks.rel_err(low, want)
        numbers["control_position_err_p50"] = float(low_err.median())
        for name, e in (("", err), ("control_", low_err)):
            numbers[name + "position_err_q"] = [
                round(float(x), 4) for x in torch.quantile(
                    e, torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9],
                                    device=e.device))]
    numbers["prefills_checked"] = len(picks)
    del params, kept
    _free()
    return {"run": run, "numbers": numbers,
            "limits": ctx["limits"]["limits"], "peak": peak,
            "attempted": done, "failed": 0,
            "e2e": {"prefill_tokens_per_s": done * S * mix["batch"] / wall},
            "notes": {"prefills": done, "setup_parts_s": _parts(parts)}}


DRIVERS = {"serve": run_serve, "prefill": run_prefill}


# ---------------------------------------------------------------- a run


def execute(ctx: dict, seed: int, seconds: float, trace: int,
            device) -> dict:
    """Run the cell and gather its result line (without printing)."""
    import torch

    from portbench.harness import checks
    from portbench.harness.trace import breakdown

    prog = program()
    mix = ctx["mix"]
    ctx.setdefault("sync", torch.cuda.synchronize if device.type == "cuda"
                   else (lambda: None))
    calls = mix["trace_calls"] if trace else 0
    t_start = ctx.get("process_start", process_start())
    out = DRIVERS[mix["kind"]](ctx, prog, seed, seconds, calls, device)
    run = out["run"]
    # the window's start on the wall clock, less the process's start
    t0_wall = time.time() - (time.perf_counter() - run["t0"])
    setup_s = t0_wall - t_start
    metrics = {}
    if trace:
        for m in ctx["per_layer"]:
            val = reader(ctx["root"], m["name"])(run)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in ctx["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    ok, compared = checks.verdict(out["numbers"], out["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": ok, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if trace and run["trace"] is not None:
        tr = run["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = breakdown(tr)
    result["checks"] = compared
    return {"result": result, "numbers": out["numbers"],
            "notes": out["notes"], "setup_s": setup_s}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    process_env(ROOT)
    try:
        ctx = load_cell(ROOT, args.workload)
    except (CellError, OSError, KeyError, ValueError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    need = ctx["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"torch sees {have}", file=sys.stderr)
        return 2
    try:
        program()
    except ImportError as e:
        print(f"portbench: the program does not import: {e}",
              file=sys.stderr)
        return 2
    ctx["process_start"] = t_start
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = execute(ctx, args.seed, args.seconds, args.trace, device)
    # the process that prints the result may not hold JAX or the JAX
    # package once the window has closed
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    res = out["result"]
    from portbench.harness.costs import HW, card_line
    print(f"portbench: {args.workload} seed {args.seed}: card {card_line()}; "
          f"peaks {HW['flops_bf16']:.4g} FLOP/s bf16, {HW['hbm_bw']:.4g} "
          f"B/s; setup_s {out['setup_s']:.3f}; {out['notes']}",
          file=sys.stderr)
    for name, c in res["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0
