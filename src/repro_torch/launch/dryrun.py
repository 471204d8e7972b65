"""Dry run of every (arch x shape) cell on one H100: trace the real step
on meta tensors, count its costs and its peak memory, bound it (port of
``repro/launch/dryrun.py``).

For each applicable cell this builds the cell's parameters
(``models/model.py::param_leaves``), optimizer state
(``training/train_step.py::init_train_state``) or decode cache
(``models/model.py::decode_state``) and batch as meta tensors, which
carry shapes and dtypes and no data, and runs the cell's step on them
once under ``analysis/costs.py::CostCounter``:

  train    ``make_train_step`` (forward, backward, AdamW);
  prefill  ``forward`` and the argmax of the last logits, under
           ``torch.inference_mode`` (the reference's ``prefill_step``);
  decode   ``serve_step`` (one new token against a ``seq_len`` cache).

The kernels' wrappers take meta tensors down their no-data branch
(``kernels/fake.py``): they allocate what their CUDA branch allocates and
report their ``cost(...)``, and nothing is built or launched.  Each cell
records:

  * ``memory.per_device_bytes``, the peak of live device storage (each
    storage rounded to 512 bytes, as the caching allocator rounds), split
    at the peak into params, optimizer, state and the rest, and
    ``fits_hbm`` against the card's 80 GB — the counterpart of
    ``compiled.memory_analysis()``;
  * ``costs``: the counted flops and bytes (``CostCounter.result``);
  * ``kernels``: each kernel's calls, operations and bytes;
  * ``roofline``: the three terms and the bound (``analysis/roofline``);
  * ``t_trace_s``, the time of the trace on the host, in place of the
    reference's lower and compile times.

Meta tensors, not ``FakeTensorMode``'s fake ``cuda`` ones: autograd asks
a tensor's device for its stream when it records a leaf, and a torch
built without CUDA has none to give, so a train cell's backward could
not be traced there; on the meta device the forward and backward trace
anywhere, and the wrappers see no CUDA tensor either way.  No op on the
models' paths has an output shape that depends on the data (the MoE
router counts its experts' load by a scatter), so each runs as it is.

The cuts the port's launchers take are taken here too: ``--layers``
(a multiple of the config's layer group), ``--batch`` and ``--seq``;
each is listed under ``reduced``.  Train cells keep the reference's
gradient accumulation (2 microbatches, or ``TRAIN_PERF_OVERRIDES``);
a batch that does not split into them runs as 1 microbatch, and the
record says so.  A cell the card cannot run (a train cell with Mamba
layers: no SSD gradient) records the refusal under ``unsupported``.

It runs on any machine, with no card and no ``nvcc``, and writes one
JSON record a cell to ``build/dryrun`` (or ``--out``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --batch 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_map

from repro_torch.analysis.costs import CostCounter
from repro_torch.analysis.roofline import roofline_from_costs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import cell_applicability
from repro_torch.launch.mesh import HW
from repro_torch.models import model as M
from repro_torch.models.layers import Leaf
from repro_torch.perf import DEFAULT_PERF, PerfConfig
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import init_train_state, make_train_step

META = torch.device("meta")
SRC = Path(__file__).resolve().parents[2]
DEFAULT_OUT = SRC.parent / "build" / "dryrun"

# per-arch production perf defaults for TRAIN cells, the reference's
# (``repro/launch/dryrun.py:55-63``): the giant-MoE / MLA configs cannot
# afford remat-saving their head-expansion dots and use deeper grad
# accumulation; everything else uses the standard dots policy
TRAIN_PERF_OVERRIDES = {
    "deepseek-v2-236b": dict(remat="full", microbatches=8),
    "llama4-maverick-400b-a17b": dict(remat="full", microbatches=4),
    "jamba-v0.1-52b": dict(remat="full", microbatches=2),
    "pixtral-12b": dict(microbatches=4),
    "internlm2-20b": dict(microbatches=4),
    "phi3-medium-14b": dict(microbatches=4),
    "xlstm-350m": dict(remat="full"),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32, "bool": torch.bool}


def cell_config(arch: str, layers: int = 0):
    """The arch's config, its depth cut to ``layers`` if given."""
    cfg = get_config(arch)
    if layers:
        if layers % cfg.group_size:
            raise ValueError(f"--layers {layers} is no multiple of "
                             f"{cfg.name}'s group of {cfg.group_size}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def batch_leaves(cfg, kind: str, B: int, S: int) -> dict:
    """Every model input of a cell as ``{name: (shape, dtype)}``: the
    reference's ``batch_spec_leaves``, in the dtypes of the port's data
    pipeline (frames and patches f32, as ``data/pipeline.py`` gives
    them)."""
    if kind == "decode":
        return {"tokens": ((B,), "int32"), "lengths": ((B,), "int32")}
    leaves = {}
    if cfg.frontend == "audio":
        leaves["frames"] = ((B, S, cfg.d_model), "float32")
        leaves["mask"] = ((B, S), "bool")
    else:
        leaves["tokens"] = ((B, S), "int32")
        if cfg.frontend == "vision":
            leaves["patches"] = ((B, cfg.n_frontend_tokens, cfg.d_model),
                                 "float32")
    if kind == "train":
        leaves["labels"] = ((B, S), "int32")
        leaves["weights"] = ((B, S), "float32")
    return leaves


def meta_params(cfg) -> dict:
    """The parameter tree of ``param_leaves`` as meta tensors, in the
    dtypes ``init_params`` gives."""
    dtype = M.torch_dtype(cfg)
    return tree_map(
        lambda leaf: torch.empty(leaf.shape, device=META,
                                 dtype=torch.float32 if leaf.f32 else dtype),
        M.param_leaves(cfg), is_leaf=lambda x: isinstance(x, Leaf))


def build_cell(arch: str, shape_name: str, perf: PerfConfig = DEFAULT_PERF,
               *, layers: int = 0, batch: int = 0, seq: int = 0) -> tuple:
    """``(fn, args, tags, perf, notes)`` for one cell, as meta tensors:
    ``fn(*args)`` is the step, ``tags`` names the trees of parameters,
    optimizer state and decode state, ``perf`` is what the step runs
    with, and ``notes`` says how its gradient accumulation was cut."""
    cfg = cell_config(arch, layers)
    shape = SHAPES[shape_name]
    B, S = batch or shape.global_batch, seq or shape.seq_len
    notes = {}
    if shape.kind == "train":
        M.check_card_training(cfg)
        if perf.microbatches == 1:
            # the reference's baseline: 2 microbatches, or the arch's own
            perf = dataclasses.replace(perf, **{
                "microbatches": 2, **TRAIN_PERF_OVERRIDES.get(arch, {})})
        if B % perf.microbatches:
            notes["microbatches"] = (
                f"{perf.microbatches} -> 1: batch {B} does not split into "
                f"{perf.microbatches}")
            perf = dataclasses.replace(perf, microbatches=1)
    params = meta_params(cfg)
    data = {k: torch.empty(s, dtype=_DTYPES[d], device=META)
            for k, (s, d) in batch_leaves(cfg, shape.kind, B, S).items()}

    if shape.kind == "train":
        opt = init_train_state(cfg, params, perf)
        step_fn = make_train_step(cfg, perf, OptConfig(schedule=cfg.schedule))
        return (step_fn, (params, opt, data, 0),
                {"params": params, "optimizer": opt}, perf, notes)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, _ = M.forward(cfg, params, batch, perf=perf)
            return logits[:, -1].argmax(-1).to(torch.int32)
        return prefill_step, (params, data), {"params": params}, perf, notes

    state = M.decode_state(cfg, B, S, device=META)

    def serve_step(params, state, batch):
        return M.serve_step(cfg, params, state, batch["tokens"],
                            batch["lengths"], perf=perf)
    return (serve_step, (params, state, data),
            {"params": params, "state": state}, perf, notes)


def _cuts(cfg, full, shape, B: int, S: int) -> dict:
    cuts = {}
    if cfg.n_layers != full.n_layers:
        cuts["n_layers"] = f"{full.n_layers} -> {cfg.n_layers}"
    if B != shape.global_batch:
        cuts["global_batch"] = f"{shape.global_batch} -> {B}"
    if S != shape.seq_len:
        cuts["seq_len"] = f"{shape.seq_len} -> {S}"
    return cuts


def run_cell(arch: str, shape_name: str, perf: PerfConfig = DEFAULT_PERF,
             *, layers: int = 0, batch: int = 0, seq: int = 0) -> dict:
    """Trace one cell's step on meta tensors; its record."""
    cfg = cell_config(arch, layers)
    shape = SHAPES[shape_name]
    B, S = batch or shape.global_batch, seq or shape.seq_len
    ok, reason = cell_applicability(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "applicable": ok}
    if not ok:
        rec["skip_reason"] = reason
        return rec
    rec.update(n_chips=1, device=HW["name"],
               reduced=_cuts(cfg, get_config(arch), shape, B, S))
    t0 = time.perf_counter()
    try:
        with CostCounter() as cc:
            fn, args, tags, run_perf, notes = build_cell(
                arch, shape_name, perf, layers=layers, batch=B, seq=S)
            for tag, tree in tags.items():
                cc.tag(tree, tag)
            cc.reset()
            with (contextlib.nullcontext() if shape.kind == "train"
                  else torch.inference_mode()):
                fn(*args)
    except NotImplementedError as e:
        rec["unsupported"] = str(e)
        return rec
    t_trace = time.perf_counter() - t0
    costs = cc.result()
    peak = costs.pop("peak_bytes")
    rec.update({
        "t_trace_s": round(t_trace, 2),
        "perf": dataclasses.asdict(run_perf), **notes,
        "memory": {"per_device_bytes": peak,
                   "fits_hbm": bool(peak <= HW["hbm_bytes"]),
                   "hbm_bytes": HW["hbm_bytes"],
                   "at_peak": costs.pop("peak_by_tag")},
        "kernels": costs.pop("kernels"),
        "costs": costs,
    })
    run_shape = dataclasses.replace(shape, global_batch=B, seq_len=S)
    rec["roofline"] = roofline_from_costs(cfg, run_shape, costs, n_chips=1)
    return rec


# --------------------------------------------------------------- CLI driver


def _name(args, arch: str, shape: str) -> str:
    cut = "".join(f"__{k}{v}" for k, v in (("layers", args.layers),
                                           ("batch", args.batch),
                                           ("seq", args.seq)) if v)
    return f"{arch}__{shape}{cut}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every cell in subprocesses")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--moe-impl", default=None, choices=["dense", "gather"])
    ap.add_argument("--perf-json", default=None,
                    help="JSON dict of PerfConfig overrides")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (a multiple of "
                         "the config's layer group); 0 keeps the config's")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch in place of the shape's; 0 keeps it")
    ap.add_argument("--seq", type=int, default=0,
                    help="sequence (or cache) length in place of the "
                         "shape's; 0 keeps it")
    args = ap.parse_args()

    perf = DEFAULT_PERF
    if args.moe_impl:
        perf = dataclasses.replace(perf, moe_impl=args.moe_impl)
    if args.perf_json:
        perf = dataclasses.replace(perf, **json.loads(args.perf_json))

    if args.all:
        return orchestrate(args)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    os.makedirs(args.out, exist_ok=True)
    name = _name(args, args.arch, args.shape)
    status = 0
    try:
        rec = run_cell(args.arch, args.shape, perf, layers=args.layers,
                       batch=args.batch, seq=args.seq)
    except Exception as e:
        rec = {"arch": args.arch, "shape": args.shape, "applicable": True,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
        status = 1
    with open(os.path.join(args.out, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec.get("memory", {})
    summary = (rec.get("skip_reason") or rec.get("error")
               or (f"unsupported: {rec['unsupported']}"
                   if "unsupported" in rec else
                   f"ok trace={rec['t_trace_s']}s "
                   f"peak={mem['per_device_bytes'] / 1e9:.2f}GB "
                   f"fits={mem['fits_hbm']} bound="
                   f"{rec['roofline']['step_time_bound_s']:.4g}s"))
    print(f"[{name}] {summary}", flush=True)
    print(json.dumps(rec), flush=True)
    return status


def orchestrate(args) -> int:
    """Run every (arch x shape) cell, each in its own subprocess, a few at
    a time; an inapplicable cell's record is written here."""
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    cells = []
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            ok, reason = cell_applicability(get_config(arch),
                                            SHAPES[shape_name])
            if not ok:
                path = os.path.join(args.out,
                                    f"{_name(args, arch, shape_name)}.json")
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "applicable": False, "skip_reason": reason},
                              f, indent=1)
                print(f"[{arch}/{shape_name}] SKIP: {reason}", flush=True)
                continue
            cells.append((arch, shape_name))
    procs: list = []
    failures = 0

    def reap(block: bool):
        nonlocal failures
        done = []
        for p, name in procs:
            if p.poll() is not None or block:
                if p.wait():
                    failures += 1
                    print(f"[{name}] FAILED rc={p.returncode}", flush=True)
                else:
                    print(f"[{name}] done", flush=True)
                done.append((p, name))
        for d in done:
            procs.remove(d)

    for arch, shape_name in cells:
        while len(procs) >= args.jobs:
            reap(False)
            time.sleep(1.0)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape_name, "--out", args.out]
        for flag in ("moe_impl", "perf_json", "layers", "batch", "seq"):
            if getattr(args, flag):
                cmd += [f"--{flag.replace('_', '-')}",
                        str(getattr(args, flag))]
        procs.append((subprocess.Popen(cmd, env=env,
                                       stdout=subprocess.DEVNULL),
                      f"{arch}/{shape_name}"))
    reap(True)
    print(f"dry-run complete; failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
