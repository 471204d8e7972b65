#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each on standard output:

  env            torch/CUDA versions, the card, the kernel build (every
                 ``src/repro_torch/csrc/*.cu`` built by ``nvcc`` into
                 ``build/kernels``, one compiler per source, in parallel).
  lint           the port's tracelint (``repro_torch.analysis.lint``) over
                 ``src/repro_torch`` and this script with the checked-in
                 baseline: the rule table, the files read, the findings
                 (any finding fails the script) and the seconds it took.
  sass           (with kernels) the HGMMA and UTMALDG (TMA) instructions of
                 each bf16 flash forward, and the HMMA and LDGSTS (cp.async)
                 of each bf16 flash backward kernel, of the bf16 SSD state
                 and chunk-scan kernels and of the bf16 decode kernel, from
                 ``cuobjdump -sass``; fails where one is missing.
  ptxas          (with kernels) the registers and spill bytes of each flash
                 backward kernel from the build's ``-Xptxas=-v`` log; fails
                 where a bf16 one at (160, 160) or (192, 128) spills.
  kernels        each CUDA kernel against its plain PyTorch version on the
                 card, at the shapes its path gives it: the fused charge
                 and gate bit-exact over randomized tables and over
                 engine-shaped ones of 40, 1,032 and 4,104 domains
                 (negative amounts, duplicates, an in-batch ancestor
                 throttle, m = 0), every stock program, timed cold by the
                 profiler beside an empty kernel's launch floor; with the
                 shard axis, over 8 shards of 513 domains and 64 slots
                 and of 1,032 domains and 256 slots spread by a seeded
                 generator (the mixed registry), bit-exact against the
                 plain per-shard loop, one launch a call, its issue pace
                 beside the same work as 8 launches at S 1; decode
                 attention within 2e-5 (f32) and 2e-2 (bf16) and each
                 slot within 1e-2 norm-relative, at B=8,
                 H=24, Hkv=8, d=128, S_max=2048 with the short contexts
                 the engine serves and with ragged lengths up to S_max, a
                 ragged S_max, and in bf16 at S_max=32768 (123,787 live
                 keys), each bf16 call one kernel, timed cold (every call
                 on another cache set) by the profiler beside
                 ``scaled_dot_product_attention``; and in bf16 at every
                 family's heads (G 1 at d 64, G 4 over 10 kv heads, G 5,
                 G 6, Jamba's G 4, pixtral's G 4 at d 160), short and
                 filled, timed the same way; at d 160 also long (timed
                 the same way), f32 filled and ragged; the flash forward and
                 backward at the training shape (B=1, S=4096, H=24, Hkv=8,
                 d=128, bf16, causal), at a ragged S=1000, non-causal and
                 causal, f32 and bf16, at S=333 against Sk=1000 (f32 full,
                 bf16 causal), in bf16 at d 32, 64 and 80, in f32 at the
                 examples' training shapes (B 4, S 64, H 4 / 2, d 32 and
                 B 8, S 256, H 8 / 4, d 64, causal; timed beside their
                 bounds, plain versions and the library), and at each
                 new family's heads at the training shape (minicpm H 36 /
                 Hkv 36 d 64, phi3 40/10, maverick 40/8, internlm2 48/8
                 at d 128; bf16, causal, timed beside their bounds): every element
                 of out, lse, dq, dk and dv within 2e-5 (1 + |b|) in f32
                 and 2e-2 (rms(b) + |b|) in bf16, and in bf16 within 1e-2
                 norm-relative, b being the plain version's value; the
                 library's forward, backward alone and both timed beside
                 them; the flash forward at d 160 (pixtral: S 4096, H
                 32 / Hkv 8, causal, bf16, timed beside the library's
                 forward; a ragged S 1000 non-causal in f32 and bf16 and
                 causal in bf16) and its backward at pixtral's shape;
                 both passes at MLA's dk 192 / dv 128 (deepseek-v2: B 1,
                 S 4096, H 128 / 128, causal, bf16; a ragged S 1000 in f32
                 and bf16, G 1 full and G 4 causal), the full shapes
                 timed beside their bounds, plain versions and the
                 library (its backend named, or "none");
                 hubert's heads (H 16 / 16, d 80, non-causal, S 4096),
                 forward and backward, timed beside the library's; the
                 paged decode at the
                 same shapes over a permuted pool of 16-token pages
                 (-1 table entries past each length), f32 and bf16, with
                 32-token pages and v narrower than k in both, and at
                 pixtral's heads (bf16 short and filled, f32), timed as
                 the dense one; the SSD scan at
                 the Jamba prefill's shape (b=1, s=32768, nh=8, dh=1024,
                 N=16, chunk 256, bf16, B and C strided), in f32 at s=4096,
                 one chunk, a ragged dh and a steep decay, in bf16 a ragged
                 dh, a steep decay, a ragged chunk (s=100), batch 2, N=4
                 and dh=36: y within 5e-4 (1 + |b|) in f32 and as the flash
                 checks in bf16, h_final within 5e-4 (1 + |b|).  Times from
                 CUDA events; the bf16 SSD call's three kernels each from
                 ``torch.profiler``.
  engine_parity  the reduced f32 llama3.2-3b on the CPU and on the card:
                 decode logits within 1e-4, and the engine's ``report()``
                 identical in inkernel and userspace modes, under the
                 weighted step scheduler, and with the adaptive retuner
                 acting (its retune actions identical too); then the
                 reduced f32 Jamba, xLSTM (their Mamba and xLSTM leaves
                 widened), llama4-maverick and pixtral-12b the same way:
                 decode logits within 1e-4, inkernel reports and greedy
                 token streams identical.
  engine_full    the full-width llama3.2-3b (28 layers, bf16, random
                 weights from a seeded generator on the card) serving 8
                 agent sessions of 2 tenants in inkernel mode; every step
                 goes through the kernels (launch counts checked), and the
                 report must equal the same sessions' report on the CPU at
                 reduced width (the control trajectory follows session
                 phases, not token values).
  conformance    the conformance kit's standard scenarios on the card's
                 backend kinds, the device table, the sharded table at 8
                 shards and the async daemon around each
                 (``memcg_events`` skipped by the kinds' features), each
                 observation stream against the port's host tree, at the
                 kit's 16 domains (a shard) and at 4,104 (8 shards of
                 513); then the fault-injecting factories around the same
                 kinds with the fault-free plan and with a transient-only
                 plan under auto-retry; in every run the charge launches
                 equal the scenarios' charge ops.
  replay         the paper's replay drivers through the port's host tree
                 (Fig 8, Table 2's baselines, escalation waste, adaptive
                 soft limits; host-side, no card): their dicts, times and
                 the qualitative outcomes the reference tests assert.
  serve_full     ``repro_torch.launch.serve`` at full width (llama3.2-3b,
                 bf16, random weights from a seeded generator on the card)
                 over 8 trace-derived sessions in inkernel mode: the report
                 equal to the same sessions' at reduced width on the CPU,
                 at least one freeze and one throttle trigger, no
                 overshoot, the launches the steps imply; step p50/p95 and
                 tokens/s.
  families_full  ``launch.serve`` as serve_full on every other family at
                 full width (bf16, seeded random weights): minicpm-2b,
                 xlstm-350m, pixtral-12b (d 160), phi3-medium-14b and
                 internlm2-20b cut to 8 layers (the script's time),
                 llama4-maverick to 2 layers, Jamba to 8
                 and deepseek-v2-236b to 4 (the JAX package's twin of
                 it; the published form is the benchmark's
                 portbench/configs/deepseek-v2-236b.json) (the cuts
                 printed with their reason); each report equal
                 to the same config's reduced CPU run, the gate read on
                 the live table each step, one charge and one gate launch
                 a step and a decode launch per GQA attention layer a
                 step (for MLA a latent decode launch per layer);
                 step p50/p95, tokens/s, peak memory; on Jamba, xLSTM
                 and deepseek-v2, a slot the gate denies keeps its whole
                 state (deepseek's latent ckv/krope rows too) bit for bit,
                 the granted slot's attention leaves change in the
                 written row only, and a frozen-then-thawed slot's state
                 comes back bit-identical on the card.
  control_full   llama3.2-3b at full width cut to 4 layers (the
                 script's time) serving through the other
                 control planes, each against the same run at reduced
                 width on the CPU: ``backend="async"`` on serve_full's
                 sessions (the device backend's report, lifecycle in
                 daemon epochs), the same with the daemon poisoned after
                 step 40 (one rebuild, everyone finishes, root usage 0),
                 and ``backend="sharded"`` at 2 shards on engine_full's
                 two tenants (one a device group); one charge launch a
                 step in each; step p50/p95.
  train_parity   the reduced f32 llama3.2-3b (two layers, ``remat="dots"``)
                 trained 3 steps on the card through the flash kernels and
                 3 steps on the CPU through their plain versions, from the
                 same weights and batches: losses within 1e-4.
  train_full     ``repro_torch.launch.train`` on the full-width llama3.2-3b
                 (bf16, random weights from a seeded generator on the card),
                 train_4k's sequence of 4096 at batch 1, ``remat="dots"``,
                 AdamW with the cosine schedule, 8 steps (2 untimed):
                 finite losses, the first where random weights put it, and
                 the flash launches the layers imply; then the same model
                 cut to 2 layers trained 8 steps from the same weights
                 and batches through the bf16 and the f32 flash kernels
                 (``repro_torch.training.trajectory``): both loss
                 trajectories, and the bf16 loss of each warmup step
                 (0-4; the f32 run diverges after them at this rate)
                 within ``REL_BAR`` of the f32 one, relative (twice the
                 same pair's drift on the CPU at reduced width).
  prefill_parity the reduced f32 jamba-v0.1-52b (one group: 7 Mamba, 1
                 attention, 4 MoE layers) forward on the card through the
                 kernels and on the CPU through their plain versions, from
                 the same weights and tokens: logits within 1e-4 with the
                 same argmax, aux within 1e-6.
  prefill_full   ``models/model.py::forward`` under inference mode on the
                 full-width jamba-v0.1-52b cut to one 8-layer group (bf16,
                 random weights from a seeded generator on the card) at
                 prefill_32k's sequence of 32768, batch 1: one untimed and
                 3 timed prefills, each through 7 SSD and 1 flash-forward
                 launches; finite logits and the next-token cross-entropy
                 where random weights put it; then the flash forward alone
                 at that shape (H=32, Hkv=8, d=128, bf16, causal) against
                 its plain version under the bf16 bar of the kernels phase,
                 and timed beside the library call.
  frontends_full the frontend families: the reduced f32 hubert-xlarge
                 trained 3 steps on the card and on the CPU (losses
                 within 1e-4) and the reduced f32 pixtral-12b forward
                 with patches on both (logits within 1e-4); then
                 ``launch.train --arch hubert-xlarge`` at full width (48
                 layers, d 1280, bf16, train_4k's 4096 frames at batch
                 1, the masked-frame loss, ``remat="dots"``, 8 steps, 2
                 untimed: finite losses, the first where random weights
                 put it, 96 flash forward and 48 backward launches a
                 step); and ``models/model.py::forward`` under inference
                 mode on the full-width pixtral-12b (40 layers, d 5120)
                 over a 4096-token sequence whose first 1,024 positions
                 are patches: 40 d-160 flash launches a call, finite
                 logits, the text positions' cross-entropy where random
                 weights put it; 1 untimed and 3 timed calls; and
                 ``launch.train --arch pixtral-12b --layers 10`` at full
                 width (d 160's flash backward), 8 steps, checked as
                 hubert's.
  mla_full       the MLA model (the reduced f32 deepseek with the real
                 head dims, dk 192 / dv 128) forward on the card and on
                 the CPU: logits within 1e-4, then three decode steps;
                 the latent decode kernel against its plain version at
                 128 slots x 128 heads x 4096 rows (1e-2 a slot), timed;
                 and ``models/model.py::forward`` under inference mode on
                 the full-width deepseek-v2-236b (the JAX package's
                 twin; the published form is the benchmark's
                 portbench/configs/deepseek-v2-236b.json) cut to 4
                 layers over one 4096-token sequence: 4 flash launches
                 a call, finite
                 logits, the cross-entropy where random weights put it.
  examples       the example twins (``repro_torch.examples``) on the
                 card, each against the port's CPU run: quickstart from
                 seeded CPU weights (its §1-§1c lines equal, its 10 f32
                 losses within 1e-4 relative, §3's report equal, a charge
                 launch a device-table charge and engine step);
                 serve_agents ``--full`` (llama3.2-3b, 28 layers, bf16) in
                 nolimit, userspace and agentcgroup, each mode's report
                 equal to the reduced f32 CPU run's, 28 decode launches a
                 step, a charge launch a step in agentcgroup only, step
                 p50/p95 and tokens/s by mode; train_100m at its defaults
                 (d 512, 8 layers, f32, 300 steps) with
                 ``--grad-compress`` and checkpoints under ``build/``:
                 the first 5 losses within 1e-4 relative of the CPU run,
                 the last below step 0's, each kept checkpoint restoring
                 bit for bit to a copy of its step's tree, 8 flash
                 forward and backward launches a step; tokens/s, peak
                 memory, seconds.
  evaluation     the evaluation twins (``repro_torch.evaluation``) on the
                 card, each against the port's CPU run of the same call:
                 ``multitenant_isolation`` at its defaults (8 tenants, 400
                 steps, a pool of 256, 8 shards): every tenant row and
                 the victims' denial rate equal, one charge launch a step
                 in each configuration, the fairness assertions holding
                 with shares and P99 gaps equal; ``engine_overhead
                 --quick --backend async --full`` (llama3.2-3b, 28
                 layers, bf16; CI's smoke): its three gates on the card
                 (async < 1.25, core < 2.0, charge kernel P50 <= plain
                 P50), each engine run's report equal, 28 decode launches
                 a step and a charge launch a step in inkernel mode; the
                 suite ``evaluation.run`` once at full width on the same
                 weights (its engine_overhead cut to 200 timed steps a
                 run and its gate to 60 calls a side for the script's
                 time, printed): engine_fig8's reports equal in all
                 three modes (launches as serve_agents'),
                 engine_overhead's reports equal,
                 throttle_precision's mechanism reopening at
                 exactly 2000 ms (its wall clock printed), the host
                 sections (characterization, mismatch and the replay
                 drivers) and the fairness shares equal, and
                 roofline_table over the six dry-run records of the
                 dryrun phase (written under ``build/``), each row's
                 GiB/dev and terms its record's.
  dryrun         each full-width run above that measures a peak
                 (train_full, hubert's and pixtral's training, the Jamba
                 prefill, pixtral's and deepseek's forwards) against
                 ``repro_torch.launch.dryrun`` of the same step at the
                 same config, depth, batch and seq, traced on meta
                 tensors in a CPU worker while the card works: the
                 dry run's kernel calls equal the card's launches a
                 step, and its estimated peak lies within 10 % of the
                 measured one (``max_memory_allocated`` less what was
                 allocated when the run began); each run's estimated and
                 measured GB, counted TFLOP, the roofline's step bound
                 and the measured p50.
  profile        (only with ``--phases profile``) ``torch.profiler`` over
                 30 full-width engine steps: device busy and idle time, and
                 the kernels that take it.
  train_profile  (only with ``--phases train_profile``) the same over 2
                 full-width train steps of the train_full configuration.
  prefill_profile (only with ``--phases prefill_profile``) the same over 2
                 prefills of the prefill_full configuration.

The CPU engine runs that engine_parity, engine_full, serve_full,
families_full and control_full compare with, the examples' and the
evaluation twins' CPU runs and the dry runs (``cpu_reference``), run in
worker processes started with the script (``CpuRefs``), while the card
works; the script stops them before it exits.  Every ``bound_ms`` of the
kernel table comes from the kernels' own ``cost`` functions.

Then the kernel table (one JSON object), the card's ``name, power.limit``
as nvidia-smi prints them, and the result line.  Any failed check raises,
and the script exits non-zero; it also exits non-zero, printing no
result, where torch sees no CUDA device or the port's sources are not
beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:
    from repro_torch.kernels.timing import card_line, cost_bound_ms, cuda_ms
except ModuleNotFoundError:
    sys.exit("chip_smoke: the port's sources (src/repro_torch) are not "
             "beside this script; run it from the root of a checkout")

INT32_MAX = 2**31 - 1
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_BF16_NORM_REL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
    print(json.dumps(obj), flush=True)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


# ------------------------------------------------------------------ kernels


def stock_registries():
    """Every stock program alone, and all of them in one registry."""
    from repro_torch.kernels.enforcement_bench import registries
    return registries()


def random_table(rng, n, progs, step, exact, P, device):
    """A random control table over a random depth-<=4 tree: frozen and
    throttled ancestors, hard-max walls, saturated stall counters and,
    with ``exact``, overage fractions that land delays on whole step
    quanta."""
    depth = np.zeros(n, int)
    parent = np.full(n, -1, np.int32)
    active = np.zeros(n, bool)
    active[0] = True
    for i in range(1, n):
        if rng.random() < 0.85:
            cands = [j for j in range(i) if active[j] and depth[j] < 3]
            p = int(rng.choice(cands))
            parent[i], depth[i], active[i] = p, depth[p] + 1, True
    high = np.where(rng.random(n) < 0.3, INT32_MAX,
                    rng.integers(1, 40, n)).astype(np.int32)
    usage = rng.integers(0, 45, n).astype(np.int32)
    if exact:
        high = np.where(high < INT32_MAX, 10, high).astype(np.int32)
        usage = (rng.integers(0, 4, n) * 5).astype(np.int32)
    width = max(p.n_params for p in progs)
    rows = np.stack([P.pad_row(progs[k % len(progs)].default_row(), width)
                     for k in range(n)])
    if not exact:
        rows[:, :4] *= rng.uniform(0.5, 1.5, (n, 4)).astype(np.float32)
    if width >= 10:
        rows[:, 4] = rng.uniform(0, 6, n)
        rows[:, 5] = rng.integers(0, step + 1, n)
    st = {
        "usage": usage, "high": high,
        "max": np.where(rng.random(n) < 0.4, INT32_MAX,
                        rng.integers(10, 80, n)).astype(np.int32),
        "low": np.where(rng.random(n) < 0.2, rng.integers(0, 30, n),
                        0).astype(np.int32),
        "parent": parent, "active": active,
        "priority": rng.integers(0, 3, n).astype(np.int32),
        "frozen": rng.random(n) < 0.1,
        "throttle_until": np.where(rng.random(n) < 0.2,
                                   step + rng.integers(-2, 4, n),
                                   0).astype(np.int32),
        "peak": (usage + rng.integers(0, 10, n)).astype(np.int32),
        "prog": rows.astype(np.float32),
        "prog_id": rng.integers(-1, len(progs) + 1, n).astype(np.int32),
        "mem_stall": np.where(rng.random(n) < 0.2, INT32_MAX,
                              rng.integers(0, 9, n)).astype(np.int32),
    }
    live = np.flatnonzero(active)
    return {k: torch.from_numpy(v).to(device) for k, v in st.items()}, live


def random_batch(rng, live, m, device):
    dom = rng.choice(np.concatenate([live, [-1]]), m).astype(np.int32)
    dom[rng.random(m) < 0.3] = dom[0]            # duplicates in one batch
    amt = rng.choice([0, 0, 1, 1, 2, 5, 9, 40], m).astype(np.int32)
    return (torch.from_numpy(dom).to(device),
            torch.from_numpy(amt).to(device))


def table_diff(a: dict, b: dict, keys) -> tuple[bool, float]:
    """(bit-identical?, max absolute difference) over ``keys``."""
    same, err = True, 0.0
    for k in keys:
        x, y = a[k], b[k]
        if x.dtype == torch.float32:
            same &= torch.equal(x.view(torch.int32), y.view(torch.int32))
        else:
            same &= torch.equal(x, y)
        err = max(err, (x.double() - y.double()).abs().max().item())
    return same, err


def check_enforcement(dev, seed: int) -> dict:
    """The fused charge and gate bit-exact against their plain versions:
    randomized 40-domain tables, consecutive steps feeding forward; then
    engine-shaped tables at the bench's three shapes (``engine`` n 40,
    ``wide`` n 1,032, ``beyond`` n 4,104) with negative amounts,
    duplicate domains, peaks under usage, program ids out of range, a
    slot that throttles an ancestor of a later slot, and m = 0; every
    stock registry."""
    from repro_torch.core import controller as C
    from repro_torch.core import progs as P
    from repro_torch.kernels import enforcement as K
    from repro_torch.kernels import enforcement_bench as B

    keys = ("usage", "peak", "throttle_until", "prog", "mem_stall")
    charge_err = gate_err = 0.0
    cases = 0
    for kind, progs in stock_registries().items():
        for case in range(6):
            rng = np.random.default_rng([seed, case, len(kind)])
            step = int(rng.integers(3, 40))
            st, live = random_table(rng, 40, progs, step, case % 2 == 0, P,
                                    dev)
            for _ in range(3):       # consecutive steps feed forward
                dom, amt = random_batch(rng, live, 8, dev)
                got, gk, sk = K.fused_charge_batch(st, dom, amt, step, progs)
                want, gp, sp = C._plain_charge_batch(st, dom, amt, step,
                                                     progs)
                same, err = table_diff(got, want, keys)
                same &= torch.equal(gk, gp) and torch.equal(sk, sp)
                err = max(err, float((gk != gp).sum() + (sk != sp).sum()))
                if not same:
                    raise AssertionError(
                        f"fused charge differs from the plain version "
                        f"({kind}, case {case}, step {step}): err {err}")
                charge_err = max(charge_err, err)
                gate_k = K.fused_slot_gate(got, dom, step + 1, progs)
                gate_p = C._plain_slot_gate(got, dom, step + 1, progs)
                if not torch.equal(gate_k, gate_p):
                    raise AssertionError(f"fused gate differs ({kind})")
                gate_err = max(gate_err, float((gate_k != gate_p).sum()))
                st = dict(st, **{k: got[k] for k in keys})
                step += int(rng.integers(0, 3))
                cases += 1
    options = (dict(negative=True, dup=True, peak_below=True,
                    prog_oob=True),
               dict(ancestor=True, peak_below=True), dict(empty=True))
    shapes = {}
    for shape, spec in B.SHAPES.items():
        for kind, progs in stock_registries().items():
            for i, opt in enumerate(options):
                opt = dict(opt)
                empty = opt.pop("empty", False)
                st, dom, amt, step = B.engine_case(
                    spec["slots"], progs, seed * 1000 + i, dev, **opt)
                if empty:
                    dom, amt = dom[:0], amt[:0]
                got, gk, sk = K.fused_charge_batch(st, dom, amt, step, progs)
                want, gp, sp = C._plain_charge_batch(st, dom, amt, step,
                                                     progs)
                same, err = table_diff(got, want, keys)
                same &= torch.equal(gk, gp) and torch.equal(sk, sp)
                if not same:
                    raise AssertionError(
                        f"fused charge differs from the plain version "
                        f"({shape}, {kind}, {opt}, empty={empty}): err "
                        f"{err}")
                if opt.get("ancestor") and not (bool(gp[0]) and not
                                                bool(gp[1]) and bool(sp[1])):
                    raise AssertionError(f"the in-batch ancestor throttle "
                                         f"did not happen ({shape}, {kind})")
                gate_k = K.fused_slot_gate(got, dom, step + 1, progs)
                gate_p = C._plain_slot_gate(got, dom, step + 1, progs)
                if not torch.equal(gate_k, gate_p):
                    raise AssertionError(f"fused gate differs ({shape}, "
                                         f"{kind}, {opt})")
                shapes[shape] = shapes.get(shape, 0) + 1
                cases += 1
    return {"cases": cases, "engine_shaped_cases": shapes,
            "charge_max_abs_err": charge_err, "gate_max_abs_err": gate_err}


def check_shard_enforcement(dev, seed: int) -> dict:
    """The shard axis: the charge and gate over the bench's two shard
    shapes (``groups``: S 8 x n 513 x m 64, a node's 8 slots a group;
    ``spread``: S 8 x n 1,032 x m 256 over shards from a seeded
    generator; the mixed stock registry), two steps feeding forward,
    bit-exact against the plain per-shard loop, one launch a call; then
    the issue pace of each beside the same work as 8 launches at S 1."""
    from repro_torch.core import controller as C
    from repro_torch.kernels import enforcement as K
    from repro_torch.kernels import enforcement_bench as B

    keys = ("usage", "peak", "throttle_until", "prog", "mem_stall")
    out = {}
    for shape, spec in B.SHARD_SHAPES.items():
        cases = 0
        for case_seed in range(2):
            st, dom, amt, step, progs = B.shard_case(shape, dev,
                                                     seed * 10 + case_seed)
            for _ in range(2):
                before = (K.fused_charge_batch.launches,
                          K.fused_slot_gate.launches)
                got, gk, sk = K.fused_charge_batch(st, dom, amt, step, progs)
                gate_k = K.fused_slot_gate(got, dom, step + 1, progs)
                if (K.fused_charge_batch.launches - before[0],
                        K.fused_slot_gate.launches - before[1]) != (1, 1):
                    raise AssertionError(f"{shape}: not one launch a call")
                want, gp, sp = C._plain_charge_shards(st, dom, amt, step,
                                                      progs)
                same, err = table_diff(got, want, keys)
                if not (same and torch.equal(gk, gp)
                        and torch.equal(sk, sp)):
                    raise AssertionError(f"shard-axis charge differs from "
                                         f"the plain loop ({shape}): {err}")
                if not torch.equal(gate_k, C._plain_gate_shards(
                        got, dom, step + 1, progs)):
                    raise AssertionError(f"shard-axis gate differs "
                                         f"({shape})")
                st = dict(st, **{k: got[k] for k in keys})
                step += 1
                cases += 1
        # the issue pace from CUDA events (the profiler's device times of
        # these shapes come from enforcement_bench, in its own process)
        st, dom, amt, step, progs = B.shard_case(shape, dev, seed)
        slices = [({k: v[s] for k, v in st.items()}, dom[s])
                  for s in range(dom.shape[0])]
        calls = {
            "charge": (lambda: K.fused_charge_batch(st, dom, amt, step,
                                                    progs),
                       lambda: [K.fused_charge_batch(sub, d, amt, step, progs)
                                for sub, d in slices],
                       B.charge_bound(st, dom)),
            "gate": (lambda: K.fused_slot_gate(st, dom, step, progs),
                     lambda: [K.fused_slot_gate(sub, d, step, progs)
                              for sub, d in slices],
                     B.gate_bound(st, dom))}
        out[shape] = {"S": spec["shards"], "n": spec["n"],
                      "m": spec["slots"], "cases": cases, "max_abs_err": 0.0}
        for k, (one, loop, bound) in calls.items():
            out[shape][k] = {"issue_ms": cuda_ms(one, spec["calls"]),
                             "as_shard_launches_issue_ms": cuda_ms(
                                 loop, spec["calls"]),
                             "bound_ms": bound[0], "bound_by": bound[1]}
    return out


def time_enforcement(dev, seed: int) -> dict:
    """The two kernels at the bench's ``engine`` shape (engine_full's
    table: n = 4 * 8 + 8 domains, m = 8 slots, the graduated program,
    P = 4): the device time a call from the profiler, cold (a 64 MB
    write between calls), the issue pace, the launch floor (an empty
    kernel through the same ctypes path) and the bytes bound."""
    from repro_torch.core import controller as C
    from repro_torch.kernels import enforcement as K
    from repro_torch.kernels import enforcement_bench as B

    st, dom, amt, step, progs = B.shape_case("engine", dev, seed)

    def charge():
        return K.fused_charge_batch(st, dom, amt, step, progs)

    def gate():
        return K.fused_slot_gate(st, dom, step, progs)

    ms, _ = B.cold_device_ms(charge, "charge_kernel", 200, dev)
    gms, _ = B.cold_device_ms(gate, "gate_kernel", 200, dev)
    floor, _ = B.cold_device_ms(lambda: K.empty_launch(dev), "empty_kernel",
                                200, dev)
    extra = {"launch_floor_ms": floor,
             "launch_floor_issue_ms": cuda_ms(lambda: K.empty_launch(dev),
                                              200)}
    plain = cuda_ms(lambda: C._plain_charge_batch(st, dom, amt, step,
                                                  progs), 20)
    gplain = cuda_ms(lambda: C._plain_slot_gate(st, dom, step, progs), 20)
    return {"charge": (ms, plain, B.charge_bound(st, dom)),
            "gate": (gms, gplain, B.gate_bound(st, dom)),
            "charge_extra": dict(extra, issue_ms=cuda_ms(charge, 200)),
            "gate_extra": dict(extra, issue_ms=cuda_ms(gate, 200))}


def decode_close(got, want, lengths) -> dict:
    """The decode kernel's ``got`` against the plain version's ``want``:
    the largest absolute difference (the bar: ATTN_TOL of the dtype, for
    every element), the norm-relative error ||got - want|| / ||want||,
    its largest over the live slots (the bar: FLASH_BF16_NORM_REL for
    each slot; a slot of n live keys has |out| near sqrt(e / n), ~0.01 at
    32768 keys, so the absolute bar alone would pass a slot that lost a
    CTA's share of its keys), and whether both bars hold and every slot
    of length 0 is exactly 0."""
    tol = ATTN_TOL[want.dtype]
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    live = lengths > 0
    slot_rel = (diff.flatten(1).norm(dim=1)
                / want.flatten(1).norm(dim=1).clamp(min=1e-30))[live]
    slot_rel = slot_rel.max().item() if slot_rel.numel() else 0.0
    ok = diff.max().item() <= tol and slot_rel <= FLASH_BF16_NORM_REL \
        and not bool(got[~live].any())
    return {"max_abs": diff.max().item(),
            "norm_rel": (diff.norm() / want.norm().clamp(min=1e-30)).item(),
            "slot_norm_rel": slot_rel, "bar": tol,
            "slot_bar": FLASH_BF16_NORM_REL, "ok": ok}


def time_decode(fn, layout: str, dev, library=None) -> dict:
    """A bf16 decode wrapper at each shape of ``kernels/decode_bench.py``
    (short agent contexts, caches filled to S_max, long context), cold
    (each call on another cache set): device time and kernels a call
    from the profiler, the issue pace from CUDA events, the bound, and
    the library call timed the same way.  Fails unless a call runs
    exactly one kernel."""
    from repro_torch.kernels import decode_bench as DB

    out = {}
    for shape, spec in DB.SHAPES.items():
        sets = DB.cache_sets(shape, layout, dev)
        r = DB.measure(fn, sets, spec["calls"])
        if r["kernels_per_call"] != 1:
            raise AssertionError(f"a bf16 {layout} decode call ran "
                                 f"{r['kernels']}, not one kernel")
        r["bound"] = DB.bound(shape, layout == "paged")
        if library is not None:
            r["library_ms"] = DB.measure(library, sets,
                                         spec["calls"])["device_ms"]
        out[shape] = r
        del sets
        torch.cuda.empty_cache()
    return out


def check_decode(dev, seed: int) -> dict:
    """The decode kernel against its plain version, each case as
    ``decode_close`` says, at the heads of engine_full (B 8, H 24, Hkv 8,
    d 128) and each shape of ``kernels/decode_bench.py`` in bf16: short
    agent contexts as the engine serves (S_max 2048), caches filled to
    ragged lengths up to S_max 2048, with f32 beside it, and S_max 32768;
    and a ragged S_max of 1001 with an empty slot in both dtypes.  Then
    the bf16 kernel's times (``time_decode``) beside
    ``scaled_dot_product_attention``'s, and the plain version's at the
    short shape."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import decode_bench as DB

    B, H, hkv, d = (DB.HEADS[k] for k in ("B", "H", "hkv", "d"))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for shape, spec in DB.SHAPES.items():
        s_max = spec["s_max"]
        lengths = torch.tensor(spec["lengths"], dtype=torch.int32,
                               device=dev)
        dtypes = (torch.float32, torch.bfloat16) if shape == "filled" \
            else (torch.bfloat16,)
        for dtype in dtypes:
            name = "f32" if dtype == torch.float32 else "bf16"
            q = torch.randn(B, H, d, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(B, s_max, hkv, d, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            cases = {f"{name}_{shape}": (q, k, v, lengths)}
            if shape == "filled":
                # a ragged S_max (no multiple of 64) and an empty slot
                cases[f"{name}_ragged"] = (
                    q[:4], k[:4, :1001].contiguous(),
                    v[:4, :1001].contiguous(),
                    torch.tensor([0, 1, 700, 1001], dtype=torch.int32,
                                 device=dev))
            for case, args in cases.items():
                want = A.decode_attention_plain(*args)
                r = decode_close(A.decode_attention(*args), want, args[-1])
                if not r["ok"]:
                    raise AssertionError(f"decode attention {case}: {r}")
                out[case] = r
            if shape == "short":
                out["library_max_abs_err"] = (
                    DB.library(q, k, v, lengths).float()
                    - A.decode_attention_plain(q, k, v, lengths).float()
                ).abs().max().item()
                plain = cuda_ms(
                    lambda: A.decode_attention_plain(q, k, v, lengths), 20)
            del q, k, v, cases
    torch.cuda.empty_cache()
    out["times"] = time_decode(A.decode_attention, "dense", dev, DB.library)
    t = out["times"]["short"]
    out["timing"] = (t["device_ms"], plain, t["bound"], t["library_ms"])
    out.update(check_decode_groups(dev, seed))
    out.update(check_decode_d160(dev, seed))
    return out


# the heads of each decoder family's attention layers at the engine's 8
# slots: G = H / Hkv query heads a kv head are the live rows of the
# kernel's 16-row mma tile
DECODE_GROUPS = {
    "minicpm_G1_d64": dict(B=8, H=36, hkv=36, d=64),
    "phi3_G4_d128": dict(B=8, H=40, hkv=10, d=128),
    "maverick_G5_d128": dict(B=8, H=40, hkv=8, d=128),
    "internlm2_G6_d128": dict(B=8, H=48, hkv=8, d=128),
    "jamba_G4_d128": dict(B=8, H=32, hkv=8, d=128),
    "pixtral_G4_d160": dict(B=8, H=32, hkv=8, d=160),
}
# pixtral-12b's attention heads at the engine's 8 slots
PIXTRAL_HEADS = DECODE_GROUPS["pixtral_G4_d160"]


def check_decode_groups(dev, seed: int) -> dict:
    """The bf16 decode kernel at each family's heads (``DECODE_GROUPS``),
    at the short contexts the engine serves and at caches filled to
    ragged lengths up to S_max 2048: each case against the plain version
    as ``decode_close`` says, then timed cold as ``time_decode`` does
    (one kernel a call), beside its bound, the plain version (issue pace)
    and ``scaled_dot_product_attention``."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import decode_bench as DB

    out, times = {}, {}
    for name, heads in DECODE_GROUPS.items():
        times[name] = {}
        for shape in ("short", "filled"):
            sets = DB.cache_sets(shape, "dense", dev, seed, heads=heads)
            args = sets[0]
            r = decode_close(A.decode_attention(*args),
                             A.decode_attention_plain(*args), args[-1])
            if not r["ok"]:
                raise AssertionError(f"decode attention {name} {shape}: {r}")
            out[f"bf16_{name}_{shape}"] = r
            calls = DB.SHAPES[shape]["calls"]
            m = DB.measure(A.decode_attention, sets, calls)
            if m["kernels_per_call"] != 1:
                raise AssertionError(f"a bf16 decode call at {name} ran "
                                     f"{m['kernels']}, not one kernel")
            times[name][shape] = {
                "ms": m["device_ms"], "issue_ms": m["issue_ms"],
                "plain_ms": cuda_ms(
                    lambda: A.decode_attention_plain(*args), 20),
                "bound_ms": DB.bound(shape, False, heads)[0],
                "library_ms": DB.measure(DB.library, sets,
                                         calls)["device_ms"],
                "max_abs_err": r["max_abs"],
                "slot_norm_rel_err": r["slot_norm_rel"]}
            del sets, args
            torch.cuda.empty_cache()
    out["group_times"] = times
    return out


def check_decode_d160(dev, seed: int) -> dict:
    """The decode kernel at pixtral's heads beyond ``check_decode_groups``'
    short and filled bf16 cases: the long context of ``decode_bench``
    (S_max 32768) against the plain version as ``decode_close`` says,
    timed cold (one kernel a call) beside its bound, the plain version
    and the library call; f32 at the filled shape and at a ragged S_max
    of 1001 with an empty slot."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import decode_bench as DB

    out = {}
    spec = DB.SHAPES["long"]
    sets = DB.cache_sets("long", "dense", dev, seed, heads=PIXTRAL_HEADS)
    args = sets[0]
    r = decode_close(A.decode_attention(*args),
                     A.decode_attention_plain(*args), args[-1])
    if not r["ok"]:
        raise AssertionError(f"decode d160 long: {r}")
    out["bf16_d160_long"] = r
    m = DB.measure(A.decode_attention, sets, spec["calls"])
    if m["kernels_per_call"] != 1:
        raise AssertionError(f"a d-160 decode call ran {m['kernels']}, "
                             "not one kernel")
    out["long_times"] = {
        "ms": m["device_ms"], "issue_ms": m["issue_ms"],
        "bound_ms": DB.bound("long", False, PIXTRAL_HEADS)[0],
        "plain_ms": cuda_ms(lambda: A.decode_attention_plain(*args), 3, 1),
        "library_ms": DB.measure(DB.library, sets,
                                 spec["calls"])["device_ms"],
        "max_abs_err": r["max_abs"], "slot_norm_rel_err": r["slot_norm_rel"]}
    del sets, args
    torch.cuda.empty_cache()
    B, H, hkv, d = (PIXTRAL_HEADS[k] for k in ("B", "H", "hkv", "d"))
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, s_max, lens in (
            ("f32_d160_filled", 2048, DB.SHAPES["filled"]["lengths"]),
            ("f32_d160_ragged", 1001, [0, 1, 700, 1001, 5, 64, 65, 999])):
        q = torch.randn(B, H, d, generator=g, device=dev)
        k, v = (torch.randn(B, s_max, hkv, d, generator=g, device=dev)
                for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        r = decode_close(A.decode_attention(q, k, v, lengths),
                         A.decode_attention_plain(q, k, v, lengths), lengths)
        if not r["ok"]:
            raise AssertionError(f"decode {name}: {r}")
        out[name] = r
    return out


FLASH_TRAIN = dict(B=1, S=4096, H=24, hkv=8, d=128)


def _flash_inputs(g, dev, dtype, B, S, H, hkv, d, Sk=None, dv=None):
    """q, k, v and dout: q and k ``d`` wide, v and dout ``dv`` (d)."""
    Sk, dv = Sk or S, dv or d
    return [torch.randn(*shape, generator=g, device=dev).to(dtype)
            for shape in ((B, S, H, d), (B, Sk, hkv, d), (B, Sk, hkv, dv),
                          (B, S, H, dv))]


def flash_close(a, b, dtype) -> dict:
    """The kernel's ``a`` against the plain version's ``b``: the largest
    absolute difference, the norm-relative error ||a - b|| / ||b||, and
    whether both hold the tolerance ``tol`` of the dtype.  In f32 every
    element must lie within tol * (1 + |b|).  In bf16 every element must
    lie within tol * (rms(b) + |b|) -- one bf16 rounding of a large
    gradient passes, a wrong small one does not -- and the norm-relative
    error within FLASH_BF16_NORM_REL."""
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    tol = ATTN_TOL[dtype]
    rel = (diff.norm() / b.norm().clamp(min=1e-30)).item()
    if dtype == torch.float32:
        ok = bool((diff <= tol * (1 + b.abs())).all())
    else:
        rms = b.square().mean().sqrt()
        ok = bool((diff <= tol * (rms + b.abs())).all()) \
            and rel <= FLASH_BF16_NORM_REL
    return {"max_abs": diff.max().item(), "norm_rel": rel, "ok": ok}


def _flash_errs(FA, R, q, k, v, do, causal) -> dict:
    """``flash_close`` of the kernels against the plain versions on the
    same inputs, for out, lse, dq, dk and dv."""
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    grads = FA.flash_bwd(q, k, v, out, lse, do, causal=causal)
    want_out, want_lse = R.flash_fwd(q, k, v, causal=causal)
    want = R.flash_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    pairs = zip(("out", "lse", "dq", "dk", "dv"), (out, lse) + tuple(grads),
                (want_out, want_lse) + tuple(want))
    return {name: flash_close(a, b, q.dtype) for name, a, b in pairs}


# library -> kernel -> (its instantiations, the SASS instructions each
# must hold): the flash kernels' six (dk, dv) pairs (d 32, 64, 80, 128,
# 160 and MLA's 192 / 128) in the forward and the dq pass, the 4-warp
# dk/dv kernel's four up to d 128 and the paired one's two above it; the decode kernel's nine (dk, dv) pairs of 32, 64 and 128, and d 160
KERNEL_SASS = {
    "flash_attention": {"fwd_wgmma_kernel": (6, ("HGMMA", "UTMALDG")),
                        "dq_mma_kernel": (6, ("HMMA", "LDGSTS")),
                        "dkdv_mma_kernel": (4, ("HMMA", "LDGSTS")),
                        "dkdv_pair_kernel": (2, ("HMMA", "LDGSTS"))},
    "mamba_scan": {"ssd_state_kernel": (1, ("HMMA", "LDGSTS")),
                   "ssd_chunk_scan_kernel": (1, ("HMMA", "LDGSTS"))},
    "decode_attention": {"decode_mma_kernel": (10, ("HMMA", "LDGSTS"))},
}


def kernel_sass(libs: dict) -> dict:
    """How many tensor-core and async-copy instructions each bf16 kernel
    of ``KERNEL_SASS`` holds, from ``cuobjdump -sass`` on the built
    library: the flash forward HGMMA (wgmma) and UTMALDG (TMA loads); the
    flash dq and dk/dv kernels, the SSD state and chunk-scan kernels and
    the decode kernel HMMA (mma.sync) and LDGSTS (cp.async)."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = {}
    for lib, kernels in KERNEL_SASS.items():
        sass = subprocess.run([str(tool), "-sass", str(libs[lib])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts = {}
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0]
            for kernel, (_, ops) in kernels.items():
                key = kernel_key(name, kernel)
                if key:
                    counts[key] = {op: block.count(op) for op in ops}
        missing = [k for k, c in counts.items() if not all(c.values())]
        copies = {kernel: sum(1 for k in counts
                              if k.split("<")[0] == kernel)
                  for kernel in kernels}
        if copies != {k: n for k, (n, _) in kernels.items()} or missing:
            raise AssertionError(f"{lib} SASS: {counts}")
        out[lib] = counts
    return out


def check_flash(dev, seed: int) -> dict:
    """The flash forward and backward against their plain versions: at
    the training shape (bf16, causal) with times, bounds and the library
    yardstick (forward, backward alone, both), at a ragged S in f32 and
    bf16, causal and not, at Sq != Sk, and at every other head dim."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    cases = [("train_bf16_causal", torch.bfloat16, True, FLASH_TRAIN)]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            cases.append((f"ragged_{'f32' if dtype == torch.float32 else 'bf16'}"
                          f"_{'causal' if causal else 'full'}", dtype, causal,
                          dict(B=2, S=1000, H=24, hkv=8, d=128)))
    cases.append(("cross_f32_full", torch.float32, False,
                  dict(B=1, S=333, H=6, hkv=2, d=80, Sk=1000)))
    cases.append(("cross_bf16_causal", torch.bfloat16, True,
                  dict(B=1, S=333, H=6, hkv=2, d=80, Sk=1000)))
    for d in (32, 64, 80):
        cases.append((f"head{d}_bf16_causal", torch.bfloat16, True,
                      dict(B=1, S=1000, H=8, hkv=2, d=d)))
    cases += [(name, torch.float32, True, shape)
              for name, shape in FLASH_EXAMPLES.items()]
    # each new family's heads at the training shape
    for name, heads in FLASH_GROUPS.items():
        cases.append((f"group_{name}_bf16_causal", torch.bfloat16, True,
                      dict(B=1, S=4096, **heads)))
    family_times, example_times = {}, {}
    for name, dtype, causal, shape in cases:
        q, k, v, do = _flash_inputs(g, dev, dtype, **shape)
        errs = _flash_errs(FA, R, q, k, v, do, causal)
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"flash {name}: {errs} over "
                                 f"{ATTN_TOL[dtype]}")
        out[name] = errs
        if name.startswith("group_"):
            family_times[name] = _flash_times(FA, q, k, v, do, **shape)
        if name in FLASH_EXAMPLES:
            example_times[name] = dict(
                _flash_times(FA, q, k, v, do, plain=R, **shape),
                library=library_attention(q, k, v, do, causal))
    out["family_times"] = family_times
    out["times_by_example"] = example_times
    # the training shape: times against the bound and the library call
    q, k, v, do = _flash_inputs(g, dev, torch.bfloat16, **FLASH_TRAIN)
    o, lse = FA.flash_fwd(q, k, v, causal=True)
    fwd_ms = cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=True), 10, 2)
    bwd_ms = cuda_ms(lambda: FA.flash_bwd(q, k, v, o, lse, do, causal=True),
                     5, 1)
    fwd_plain = cuda_ms(lambda: R.flash_fwd(q, k, v, causal=True), 3, 1)
    bwd_plain = cuda_ms(lambda: R.flash_bwd(q, k, v, o, lse, do,
                                            causal=True), 3, 1)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    lq, lk, lv = (t.detach().requires_grad_() for t in (qs, ks, vs))
    dos = do.transpose(1, 2)

    def lib_fwd_bwd():
        y = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(y, (lq, lk, lv), dos)

    lib_err = (lib_fwd().transpose(1, 2).float() - o.float()).abs().max()
    lib_f = cuda_ms(lib_fwd, 10, 2)
    lib_fb = cuda_ms(lib_fwd_bwd, 5, 1)
    # the library's backward alone, over one retained forward
    y = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                       enable_gqa=True)
    lib_b = cuda_ms(lambda: torch.autograd.grad(y, (lq, lk, lv), dos,
                                                retain_graph=True), 5, 1)
    # the work and the bounds: the kernels' own ``cost``
    fwd = FA.cost(q, k, v, causal=True)
    bwd = FA.cost(q, k, v, causal=True, backward=True)
    out["timing"] = {
        "flash_fwd": (fwd_ms, fwd_plain, cost_bound_ms(fwd), lib_f),
        "flash_bwd": (bwd_ms, bwd_plain, cost_bound_ms(bwd), lib_b)}
    out["library_fwd_bwd_ms"] = lib_fb
    out["fwd_tflops"] = fwd["ops"] / fwd_ms / 1e9
    out["bwd_tflops"] = bwd["ops"] / bwd_ms / 1e9
    out["library_max_abs_err"] = lib_err.item()
    return out


# the new families' attention heads: minicpm (G 1, d 64), phi3 (G 4 over
# 10 kv heads), maverick (G 5), internlm2 (G 6)
FLASH_GROUPS = {
    "minicpm_G1_d64": dict(H=36, hkv=36, d=64),
    "phi3_G4_d128": dict(H=40, hkv=10, d=128),
    "maverick_G5_d128": dict(H=40, hkv=8, d=128),
    "internlm2_G6_d128": dict(H=48, hkv=8, d=128),
}


def _flash_times(FA, q, k, v, do, causal=True, backward=True, plain=None,
                 **_) -> dict:
    """The flash forward's (and backward's) issue pace at one shape,
    beside their bounds (the kernels' ``cost``) and, given the plain
    versions' module ``plain``, their times."""
    o, lse = FA.flash_fwd(q, k, v, causal=causal)
    out = {"fwd_ms": cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=causal),
                             5, 1),
           "fwd_bound_ms": cost_bound_ms(FA.cost(q, k, v,
                                                 causal=causal))[0]}
    if plain is not None:
        out["fwd_plain_ms"] = cuda_ms(
            lambda: plain.flash_fwd(q, k, v, causal=causal), 3, 1)
    if backward:
        out.update(bwd_ms=cuda_ms(lambda: FA.flash_bwd(
            q, k, v, o, lse, do, causal=causal), 3, 1),
            bwd_bound_ms=cost_bound_ms(FA.cost(q, k, v, causal=causal,
                                               backward=True))[0])
        if plain is not None:
            out["bwd_plain_ms"] = cuda_ms(lambda: plain.flash_bwd(
                q, k, v, o, lse, do, causal=causal), 3, 1)
    return out


# the examples' f32 training shapes: quickstart's reduced llama3.2-3b
# (H 4 / 2, d 32, batch 4, seq 64) and train_100m's d-512 model (H 8 / 4,
# d 64, batch 8, seq 256)
FLASH_EXAMPLES = {
    "example_quickstart_f32_causal": dict(B=4, S=64, H=4, hkv=2, d=32),
    "example_train100m_f32_causal": dict(B=8, S=256, H=8, hkv=4, d=64),
}


# pixtral-12b's heads at the training shape (d 160: a forward only) and
# hubert-xlarge's (MHA, d 80, bidirectional)
FLASH_PIXTRAL = dict(B=1, S=4096, H=32, hkv=8, d=160)
FLASH_HUBERT = dict(B=1, S=4096, H=16, hkv=16, d=80)


def check_flash_frontends(dev, seed: int) -> dict:
    """The flash forward at d 160 against its plain version (out and lse,
    ``flash_close``): pixtral's training shape (causal, bf16), timed
    beside its plain version, the library's forward and its operations
    bound; a ragged S of 1000, non-causal in f32 and bf16 and causal in
    bf16 (the backward at d 160 is ``check_flash_mla``'s).  Then hubert's
    heads (non-causal, bf16): forward and backward against the plain
    versions, timed beside their bounds and the library's forward and
    backward alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=dev).manual_seed(seed + 160)
    out, times = {}, {}
    cases = [("d160_train_bf16_causal", torch.bfloat16, True, FLASH_PIXTRAL)]
    for name, dtype, causal in (("d160_ragged_f32_full", torch.float32,
                                 False),
                                ("d160_ragged_bf16_full", torch.bfloat16,
                                 False),
                                ("d160_ragged_bf16_causal", torch.bfloat16,
                                 True)):
        cases.append((name, dtype, causal, dict(FLASH_PIXTRAL, B=2, S=1000)))
    for name, dtype, causal, shape in cases:
        q, k, v, _ = _flash_inputs(g, dev, dtype, **shape)
        got, lse = FA.flash_fwd(q, k, v, causal=causal)
        want, want_lse = R.flash_fwd(q, k, v, causal=causal)
        errs = {"out": flash_close(got, want, dtype),
                "lse": flash_close(lse, want_lse, dtype)}
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"flash {name}: {errs} over "
                                 f"{ATTN_TOL[dtype]}")
        out[name] = errs
        if name.startswith("d160_train"):
            t = _flash_times(FA, q, k, v, None, **shape, backward=False)
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
            t["plain_ms"] = cuda_ms(lambda: R.flash_fwd(q, k, v,
                                                        causal=True), 3, 1)
            t["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 10, 2)
            t["tflops"] = (FA.cost(q, k, v, causal=True)["ops"]
                           / t["fwd_ms"] / 1e9)
            times["pixtral_d160"] = t
        del q, k, v, got, lse, want, want_lse
    # hubert: both passes, non-causal
    q, k, v, do = _flash_inputs(g, dev, torch.bfloat16, **FLASH_HUBERT)
    errs = _flash_errs(FA, R, q, k, v, do, False)
    if not all(e["ok"] for e in errs.values()):
        raise AssertionError(f"flash hubert: {errs}")
    out["hubert_bf16_full"] = errs
    t = _flash_times(FA, q, k, v, do, **FLASH_HUBERT, causal=False)
    o, lse = FA.flash_fwd(q, k, v, causal=False)
    t["fwd_plain_ms"] = cuda_ms(lambda: R.flash_fwd(q, k, v, causal=False),
                                3, 1)
    t["bwd_plain_ms"] = cuda_ms(lambda: R.flash_bwd(
        q, k, v, o, lse, do, causal=False), 3, 1)
    lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    t["fwd_library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        lq.detach(), lk.detach(), lv.detach()), 10, 2)
    y = F.scaled_dot_product_attention(lq, lk, lv)
    dos = do.transpose(1, 2)
    t["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        y, (lq, lk, lv), dos, retain_graph=True), 5, 1)
    times["hubert_d80_full"] = t
    out["times"] = times
    return out


# deepseek-v2's MLA attention at full width: 128 heads of dk 192 (128 +
# 64 rope) and dv 128, k/v expanded per head from the latent (G 1)
FLASH_MLA = dict(B=1, S=4096, H=128, hkv=128, d=192, dv=128)


def library_attention(q, k, v, do, causal: bool) -> dict:
    """``scaled_dot_product_attention`` on the same inputs (heads second,
    GQA): its forward and its backward alone over one retained forward,
    timed by CUDA events, and the kernels the profiler saw a forward and
    a backward launch (the backend PyTorch picked).  Where no backend
    takes the shapes, the error instead of the times."""
    import torch.nn.functional as F

    from repro_torch.kernels.timing import device_ms

    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]

    def fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                              enable_gqa=gqa)

    try:
        fwd()
    except RuntimeError as e:
        return {"fwd_ms": None, "bwd_ms": None,
                "backend": "none", "error": str(e).splitlines()[0][:300]}
    lq, lk, lv = (x.detach().requires_grad_() for x in (qs, ks, vs))
    y = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                       enable_gqa=gqa)
    dos = do.transpose(1, 2)

    def bwd():
        return torch.autograd.grad(y, (lq, lk, lv), dos, retain_graph=True)

    out = {"fwd_ms": cuda_ms(fwd, 5, 2), "bwd_ms": cuda_ms(bwd, 3, 1),
           "fwd_kernels": sorted(k[:80] for k in device_ms(fwd, 1)),
           "bwd_kernels": sorted(k[:80] for k in device_ms(bwd, 1))}
    names = " ".join(out["fwd_kernels"]).lower()
    # cuDNN's kernel names say "flash" too, so it is asked first
    out["backend"] = ("cudnn" if "cudnn" in names else
                      "flash" if "flash" in names else
                      "efficient" if "fmha" in names or "mem_eff" in names
                      or "efficient" in names else "math")
    return out


def check_flash_mla(dev, seed: int) -> dict:
    """The flash kernels at the (dk, dv) pairs this slice added: MLA's 192 /
    128 at deepseek-v2's full attention shape (B 1, S 4096, H 128, causal,
    bf16) and at a ragged S 1000 in f32 and bf16, G 1 and G 4, causal and
    full; the backward at pixtral's d 160 (S 4096, H 32 / Hkv 8); each
    against its plain version on the same inputs under the kernels
    phase's bars (``flash_close``).  The two full shapes timed by CUDA
    events beside their bounds (the kernels' ``cost``), their plain
    versions and the library (``library_attention``)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R

    g = torch.Generator(device=dev).manual_seed(seed + 192)
    out, times = {}, {}
    cases = [("mla_train_bf16_causal", torch.bfloat16, True, FLASH_MLA,
              True),
             ("d160_bwd_train_bf16_causal", torch.bfloat16, True,
              FLASH_PIXTRAL, True)]
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        cases.append((f"mla_ragged_{name}_G1_full", dtype, False,
                      dict(B=2, S=1000, H=8, hkv=8, d=192, dv=128), False))
        cases.append((f"mla_ragged_{name}_G4_causal", dtype, True,
                      dict(B=1, S=1000, H=8, hkv=2, d=192, dv=128), False))
    for name, dtype, causal, shape, timed in cases:
        q, k, v, do = _flash_inputs(g, dev, dtype, **shape)
        errs = _flash_errs(FA, R, q, k, v, do, causal)
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"flash {name}: {errs} over "
                                 f"{ATTN_TOL[dtype]}")
        out[name] = errs
        if timed:
            t = _flash_times(FA, q, k, v, do, causal=causal)
            o, lse = FA.flash_fwd(q, k, v, causal=causal)
            t["fwd_plain_ms"] = cuda_ms(
                lambda: R.flash_fwd(q, k, v, causal=causal), 2, 1)
            t["bwd_plain_ms"] = cuda_ms(lambda: R.flash_bwd(
                q, k, v, o, lse, do, causal=causal), 2, 1)
            t["fwd_tflops"] = (FA.cost(q, k, v, causal=causal)["ops"]
                               / t["fwd_ms"] / 1e9)
            t["bwd_tflops"] = (FA.cost(q, k, v, causal=causal,
                                       backward=True)["ops"]
                               / t["bwd_ms"] / 1e9)
            t["library"] = library_attention(q, k, v, do, causal)
            times[name.split("_train")[0]] = t
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    out["times"] = times
    return out


def kernel_key(mangled: str, kernel: str):
    """``kernel<args>`` where the mangled name ``mangled`` names an
    instantiation of ``kernel`` on int template arguments (``kernel``
    alone without them), else None."""
    if kernel not in mangled:
        return None
    rest = mangled.split(kernel, 1)[1]
    if "ILi" not in rest:
        return kernel
    args = rest.split("ILi", 1)[1].split("EE")[0].split("ELi")
    return f"{kernel}<{','.join(args)}>"


def ptxas_report(log: str, kernels) -> dict:
    """Registers and spill bytes of each instantiation of ``kernels``
    (their names) in a ``nvcc -Xptxas=-v`` log: {"name<args>":
    {"registers", "spill_stores", "spill_loads"}}."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            key = next((kernel_key(m.group(1), k) for k in kernels
                        if kernel_key(m.group(1), k)), None)
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


# the flash backward's kernels whose registers and spills the build
# reports; the bf16 ones at d 160 and at MLA's 192 / 128 must not spill
FLASH_BWD_KERNELS = ("dq_mma_kernel", "dkdv_mma_kernel", "dkdv_pair_kernel",
                     "dq_kernel", "dkdv_kernel")
NO_SPILL = ("dq_mma_kernel<160,160>", "dq_mma_kernel<192,128>",
            "dkdv_pair_kernel<160,160>", "dkdv_pair_kernel<192,128>")


def flash_ptxas(libs: dict) -> dict:
    """``ptxas_report`` of the flash backward's kernels from the build's
    log; raises where a bf16 backward kernel of ``NO_SPILL`` spills or is
    missing."""
    log = libs["flash_attention"].with_suffix(".log")
    rep = ptxas_report(log.read_text() if log.exists() else "",
                       FLASH_BWD_KERNELS)
    bad = {k: rep.get(k) for k in NO_SPILL
           if rep.get(k, {}).get("spill_stores", 1)
           or rep.get(k, {}).get("spill_loads", 1)}
    if bad:
        raise AssertionError(f"flash backward spills or is missing: {bad}")
    return rep


SSD_PATH = dict(b=1, s=32768, nh=8, dh=1024, N=16, chunk=256)
SSD_F32_TOL = 5e-4


def _ssd_inputs(g, dev, dtype, b, s, nh, dh, N, chunk, a_scale=0.5,
                dt_scale=1.0):
    """x, dt = softplus(randn), A = -exp(a_scale randn), B and C as the
    two halves of one (b, s, 2N) projection (strided views, as the Mamba
    block hands them over), D; x/B/C in ``dtype``, the rest f32."""
    x = torch.randn(b, s, nh, dh, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, generator=g, device=dev)) * dt_scale
    A = -torch.exp(torch.randn(nh, generator=g, device=dev) * a_scale)
    bc = torch.randn(b, s, 2 * N, generator=g, device=dev).to(dtype)
    D = torch.randn(nh, generator=g, device=dev)
    return x, dt, A, bc[..., :N], bc[..., N:], D


def ssd_close(a, b, dtype) -> dict:
    """The kernel's ``a`` against the plain ``b``: in f32 every element
    within 5e-4 (1 + |b|); in bf16 within 2e-2 (rms(b) + |b|) and 1e-2
    norm-relative (``flash_close``'s bf16 reading)."""
    if dtype == torch.bfloat16:
        return flash_close(a, b, dtype)
    a, b = a.double(), b.double()
    diff = (a - b).abs()
    rel = (diff.norm() / b.norm().clamp(min=1e-30)).item()
    return {"max_abs": diff.max().item(), "norm_rel": rel,
            "ok": bool((diff <= SSD_F32_TOL * (1 + b.abs())).all())}


def check_ssd(dev, seed: int) -> dict:
    """The SSD scan kernels against their plain version: the prefill
    path's shape in bf16 (with times and the bound), the same in f32 at
    s=4096, one chunk, a ragged dh in f32 and bf16, and in bf16 a decay
    steep enough that exp overflows above the diagonal of a chunk, a
    ragged chunk (s=100 with chunk 256), batch 2, N=4 at chunk 256 and a
    dh of 36 (no 16-byte copies).
    Every case hands over B and C as strided halves of one projection.
    y as ``ssd_close`` says, the f32 h_final within 5e-4 (1 + |b|) in
    every case."""
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels.ssd_ablation import kernel_ms

    g = torch.Generator(device=dev).manual_seed(seed)
    steep = dict(b=1, s=512, nh=4, dh=128, N=16, chunk=256)
    cases = [("path_bf16", torch.bfloat16, SSD_PATH, {}),
             ("path_f32_s4096", torch.float32, dict(SSD_PATH, s=4096), {}),
             ("one_chunk_f32", torch.float32,
              dict(b=2, s=128, nh=2, dh=64, N=16, chunk=128), {}),
             ("ragged_dh_f32", torch.float32,
              dict(b=1, s=96, nh=3, dh=80, N=4, chunk=32), {}),
             ("ragged_dh_bf16", torch.bfloat16,
              dict(b=1, s=96, nh=3, dh=80, N=4, chunk=32), {}),
             # |dt A| ~ 3 a step: seg spans ~800 over a chunk, so exp of
             # the upper triangle would overflow many times over, while seg
             # keeps ~1e-4 of absolute precision
             ("steep_decay_f32", torch.float32, steep, dict(dt_scale=4.0)),
             ("steep_decay_bf16", torch.bfloat16, steep, dict(dt_scale=4.0)),
             ("ragged_chunk_bf16", torch.bfloat16,
              dict(b=1, s=100, nh=2, dh=64, N=16, chunk=256), {}),
             ("batch2_bf16", torch.bfloat16,
              dict(b=2, s=1024, nh=4, dh=256, N=16, chunk=256), {}),
             ("state4_bf16", torch.bfloat16,
              dict(b=1, s=1024, nh=2, dh=128, N=4, chunk=256), {}),
             # dh not a multiple of 8: x through plain loads, not cp.async
             ("dh36_bf16", torch.bfloat16,
              dict(b=1, s=64, nh=2, dh=36, N=8, chunk=32), {})]
    out = {}
    for name, dtype, shape, kw in cases:
        x, dt, A, B, C, D = _ssd_inputs(g, dev, dtype, **shape, **kw)
        y, h = MS.ssd_scan(x, dt, A, B, C, D, chunk=shape["chunk"])
        wy, wh = MS.ssd_plain(x, dt, A, B, C, D, chunk=shape["chunk"])
        torch.cuda.synchronize()
        errs = {"y": ssd_close(y, wy, dtype),
                "h": ssd_close(h, wh, torch.float32)}
        if not all(e["ok"] for e in errs.values()) \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"ssd {name}: {errs}")
        out[name] = errs
    x, dt, A, B, C, D = _ssd_inputs(g, dev, torch.bfloat16, **SSD_PATH)
    c = SSD_PATH["chunk"]

    def call():
        return MS.ssd_scan(x, dt, A, B, C, D, chunk=c)

    ms = cuda_ms(call, 10, 2)
    plain = cuda_ms(lambda: MS.ssd_plain(x, dt, A, B, C, D, chunk=c), 3, 1)
    bound = cost_bound_ms(MS.cost(x, dt, A, B, C, D, chunk=c))
    out["timing"] = (ms, plain, bound, None)
    # the bf16 call's three kernels, device time a call (profiler)
    out["kernel_ms"] = kernel_ms(call)
    return out


def check_paged(dev, seed: int) -> dict:
    """The paged decode kernel against its plain version over a permuted
    pool with -1 table entries past each length, each case as
    ``decode_close`` says: the shapes of ``check_decode`` in 16-token
    pages (short and long in bf16, filled in f32 and bf16), and 32-token
    pages with v narrower than k (d 64) and an empty slot in both
    dtypes.  Then the bf16 kernel's times (``time_decode``) and the
    plain version's at the short shape."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import decode_bench as DB

    B, H, hkv, d = (DB.HEADS[k] for k in ("B", "H", "hkv", "d"))
    g = torch.Generator(device=dev).manual_seed(seed)

    def lens_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    short, filled, long = (DB.SHAPES[k] for k in ("short", "filled", "long"))
    edges = lens_of([0, 5, 64, 100, 31, 32, 33, 2048])
    cases = [("bf16_short", torch.bfloat16, 16, d, 2048,
              lens_of(short["lengths"])),
             ("f32", torch.float32, 16, d, 2048, lens_of(filled["lengths"])),
             ("bf16", torch.bfloat16, 16, d, 2048,
              lens_of(filled["lengths"])),
             ("f32_page32_dv64", torch.float32, 32, 64, 2048, edges),
             ("bf16_page32_dv64", torch.bfloat16, 32, 64, 2048, edges),
             ("bf16_long", torch.bfloat16, 16, d, long["s_max"],
              lens_of(long["lengths"]))]
    out = {}
    for name, dtype, pg, dv, s_max, lens in cases:
        npp = s_max // pg
        tbl = torch.randperm(B * npp, generator=g, device=dev).reshape(
            B, npp).to(torch.int32)
        first = torch.arange(npp, device=dev)[None] * pg
        tbl = torch.where(first < lens[:, None], tbl, torch.full_like(tbl, -1))
        q = torch.randn(B, H, d, generator=g, device=dev).to(dtype)
        kp = torch.randn(B * npp, pg, hkv, d, generator=g,
                         device=dev).to(dtype)
        vp = torch.randn(B * npp, pg, hkv, dv, generator=g,
                         device=dev).to(dtype)
        want = A.paged_decode_attention_plain(q, kp, vp, tbl, lens)
        r = decode_close(A.paged_decode_attention(q, kp, vp, tbl, lens),
                         want, lens)
        if not r["ok"]:
            raise AssertionError(f"paged decode {name}: {r}")
        out[name] = r
        if name == "bf16_short":
            plain = cuda_ms(lambda: A.paged_decode_attention_plain(
                q, kp, vp, tbl, lens), 20)
        del q, kp, vp, want
    # pixtral's heads (G 4 over 8 kv heads, d 160): bf16 short and filled,
    # f32 filled; the bf16 short shape timed cold
    for name, shape in (("bf16_d160_short", "short"),
                        ("bf16_d160_filled", "filled"),
                        ("f32_d160", "filled")):
        sets = DB.cache_sets(shape, "paged", dev, seed, heads=PIXTRAL_HEADS)
        args = sets[0]
        if name.startswith("f32"):
            args = tuple(t.float() if t.dtype == torch.bfloat16 else t
                         for t in args)
        r = decode_close(A.paged_decode_attention(*args),
                         A.paged_decode_attention_plain(*args), args[-1])
        if not r["ok"]:
            raise AssertionError(f"paged decode {name}: {r}")
        out[name] = r
        if name == "bf16_d160_short":
            m = DB.measure(A.paged_decode_attention, sets,
                           DB.SHAPES[shape]["calls"])
            if m["kernels_per_call"] != 1:
                raise AssertionError(f"a d-160 paged call ran "
                                     f"{m['kernels']}, not one kernel")
            out["d160_times"] = {
                "short": {"ms": m["device_ms"], "issue_ms": m["issue_ms"],
                          "bound_ms": DB.bound(shape, True,
                                               PIXTRAL_HEADS)[0],
                          "plain_ms": cuda_ms(
                              lambda: A.paged_decode_attention_plain(*args),
                              20),
                          "max_abs_err": r["max_abs"]}}
        del sets, args
    torch.cuda.empty_cache()
    out["times"] = time_decode(A.paged_decode_attention, "paged", dev)
    t = out["times"]["short"]
    out["timing"] = (t["device_ms"], plain, t["bound"], None)
    return out


def decode_row(res: dict) -> dict:
    """The kernels line's fields for a decode kernel from ``check_decode``
    or ``check_paged``: the largest errors of its bf16 cases (absolute,
    norm-relative, and norm-relative in one slot); ms, the device time a
    call at the short shape (the engine's), cold; beside it the issue
    pace, and both at the filled and long shapes with their bounds."""
    bf16 = [e for case, e in res.items() if case.startswith("bf16")]
    times = res["times"]
    return {"max_abs_err": max(e["max_abs"] for e in bf16),
            "norm_rel_err": max(e["norm_rel"] for e in bf16),
            "timing": res["timing"],
            "extra": {"max_slot_norm_rel_err":
                      max(e["slot_norm_rel"] for e in bf16),
                      **({"group_shapes": res["group_times"]}
                         if "group_times" in res else {}),
                      **({"d160": {k: res[k] for k in (
                          "long_times", "d160_times") if k in res}}
                         if any(k in res for k in ("long_times",
                                                   "d160_times")) else {}),
                      "issue_ms": times["short"]["issue_ms"], **{
                          f"{shape}_context": {
                              "ms": times[shape]["device_ms"],
                              "issue_ms": times[shape]["issue_ms"],
                              "bound_ms": times[shape]["bound"][0],
                              "library_ms": times[shape].get("library_ms")}
                          for shape in ("filled", "long")}}}


# ------------------------------------------------------------------ engine


def parity_sessions(S, D):
    """The three sessions of the JAX package's engine tests."""
    return [
        S.Session(sid="hi", tenant="t", priority=D.HIGH,
                  prompt=list(range(2, 34)),
                  phases=[S.Phase(8, 96, "test"), S.Phase(8, 64, "git"),
                          S.Phase(12, 0)]),
        S.Session(sid="lo1", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
        S.Session(sid="lo2", tenant="t", priority=D.LOW,
                  prompt=list(range(2, 26)),
                  phases=[S.Phase(8, 160, "test"), S.Phase(8, 96, "test"),
                          S.Phase(8, 0)]),
    ]


def full_sessions(S, D, seed: int) -> list:
    """8 agent sessions in 2 tenants: ``fg`` runs HIGH-priority sessions,
    ``bg`` LOW ones.  Prompts of 96-160 tokens, then 2-3 reason/act
    cycles whose tool results append 64-256 tokens each."""
    rng = np.random.default_rng(seed)
    cats = ("test", "git", "python", "build")
    out = []
    for i in range(8):
        tenant, prio = ("fg", D.HIGH) if i % 2 == 0 else ("bg", D.LOW)
        plen = int(rng.integers(96, 161))
        phases = [S.Phase(int(rng.integers(8, 25)), int(rng.integers(64, 257)),
                          cats[int(rng.integers(0, len(cats)))])
                  for _ in range(int(rng.integers(2, 4)))]
        phases.append(S.Phase(int(rng.integers(8, 17)), 0))
        out.append(S.Session(sid=f"s{i}", tenant=tenant, priority=prio,
                             prompt=[2 + (i * 131 + j) % 1000
                                     for j in range(plen)],
                             phases=phases))
    return out


FULL_ENGINE = dict(max_slots=8, s_max=2048, pool_pages=160, page_tokens=16,
                   mode="inkernel", use_freeze=True,
                   session_high={"s1": 28, "s3": 28, "s5": 28, "s7": 28})


def run_engine(E, cfg, params, sessions, ecfg, device, max_steps=8000,
               prog=None):
    eng = E.Engine(cfg, params, ecfg=ecfg, seed=0, device=device)
    if prog is not None:
        eng.attach_program(prog)
    for s in sessions:
        eng.submit(s)
    eng.run(max_steps)
    if not eng.done():
        raise AssertionError(f"engine on {device} did not finish in "
                             f"{max_steps} steps")
    return eng


POISON_AFTER = 40        # steps before control_full poisons the daemon


def poison_daemon(eng) -> None:
    """control_full's hook: wedge the daemon after ``POISON_AFTER`` steps,
    as the engine tests do."""
    if eng.step_no == POISON_AFTER:
        eng.cg.backend._wedged = True


def cpu_reference(key: str, seed: int) -> dict:
    """The report of one reduced f32 run on the CPU that a full-width run
    on the card must equal: ``engine_full`` and ``sharded`` (engine_full's
    sessions on the device table and on the 2-shard sharded one),
    ``serve`` (serve_full's sessions, also control_full's device run),
    ``async`` and ``poisoned`` (control_full's daemon runs) and
    ``family:<arch>`` (families_full's); ``dryrun:<run>``, the dry run
    of a ``DRYRUN_RUNS`` run (``dry_run``); ``example:<name>``, the
    examples phase's CPU run of an example twin (``example_reference``);
    ``evaluation:<name>``, the evaluation phase's CPU run of a twin
    (``evaluation_reference``);
    for ``parity:<arch>:<mode>``,
    engine_parity's CPU run of the reduced ``arch`` in a
    ``PARITY_MODES`` mode (``parity_run``: report, token streams,
    retuner actions)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import domains as D
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import session as S

    if key.startswith("dryrun:"):
        return dry_run(key.split(":", 1)[1])
    if key.startswith("example:"):
        with contextlib.redirect_stdout(io.StringIO()):
            return example_reference(key.split(":", 1)[1], seed)
    if key.startswith("evaluation:"):
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluation_reference(key.split(":", 1)[1])
    with contextlib.redirect_stdout(io.StringIO()):
        if key.startswith("parity:"):
            _, arch, mode = key.split(":")
            cfg, params = parity_model(arch, seed)
            return parity_run(parity_engine(cfg, params, mode, "cpu"))
        if key in ("engine_full", "sharded"):
            small = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                                        dtype="float32")
            shards = dict(backend="sharded", n_shards=2) \
                if key == "sharded" else {}
            return run_engine(E, small, M.init_params(
                small, torch.Generator().manual_seed(seed), device="cpu"),
                full_sessions(S, D, seed),
                E.EngineConfig(**FULL_ENGINE, **shards), "cpu").report()
        if key.startswith("family:"):
            return SV.run(SV.parser().parse_args(
                SERVE_FULL[2:] + ["--arch", key.split(":", 1)[1], "--seed",
                                  str(seed), "--reduced", "--device", "cpu"]))
        small = SV.parser().parse_args(SERVE_FULL + [
            "--seed", str(seed), "--reduced", "--device", "cpu"])
        if key == "serve":
            return SV.run(small)
        eng, _ = SV.serve(small, backend="async", after_step=(
            poison_daemon if key == "poisoned" else None))
        try:
            return eng.report()
        finally:
            eng.close()


def _cpu_worker() -> None:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


class CpuRefs:
    """The reduced CPU runs (``cpu_reference``) of the phases to run,
    started with the script in worker processes of their own (spawned,
    one thread each, no card) so that they run while the card works;
    ``get`` waits for one and raises its failure, ``close`` stops the
    workers."""
    WORKERS = 4
    WAIT_S = 900

    def __init__(self, phases: list, seed: int):
        keys = []
        for phase, want in (("engine_parity",
                             [f"parity:llama3.2-3b:{m}" for m in PARITY_MODES]
                             + [f"parity:{a}:inkernel"
                                for a in PARITY_FAMILIES]),
                            ("engine_full", ["engine_full"]),
                            ("serve_full", ["serve"]),
                            ("families_full",
                             [f"family:{a}" for a in FAMILIES_FULL]),
                            ("control_full",
                             ["serve", "async", "poisoned", "sharded"]),
                            ("examples",
                             [f"example:{n}" for n in ("train_100m",
                                                       "quickstart",
                                                       "serve_agents")]),
                            ("evaluation",
                             [f"evaluation:{n}" for n in ("suite",
                                                          "multitenant",
                                                          "engine_overhead")]
                             + [f"dryrun:{n}" for n in DRYRUN_RUNS])):
            if phase in phases:
                keys += [k for k in want if k not in keys]
        if "dryrun" in phases:
            keys += [k for k in (f"dryrun:{n}" for n, (p, *_)
                                 in DRYRUN_RUNS.items() if p in phases)
                     if k not in keys]
        self.pool = multiprocessing.get_context("spawn").Pool(
            min(self.WORKERS, len(keys)), initializer=_cpu_worker) \
            if keys else None
        self.runs = {k: self.pool.apply_async(cpu_reference, (k, seed))
                     for k in keys}

    def get(self, key: str) -> dict:
        return self.runs[key].get(timeout=self.WAIT_S)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()


# engine_parity's engine settings: the JAX package's engine tests' slots,
# pool and LOW ``memory.high``, in each mode (``adaptive``: the
# closed-loop retuner of its engine test, acting on the live engine)
PARITY_COMMON = dict(max_slots=4, s_max=384, pool_pages=40, page_tokens=16,
                     session_high={"lo1": 12, "lo2": 12})
PARITY_MODES = {
    "inkernel": dict(mode="inkernel", use_freeze=True),
    "userspace": dict(mode="userspace", use_freeze=False,
                      use_tool_domains=False, use_intent=False),
    "inkernel_sched": dict(mode="inkernel", use_freeze=True, sched_slots=2),
    "inkernel_adaptive": dict(mode="inkernel", use_freeze=True)}


def parity_model(arch: str, seed: int):
    """The reduced f32 ``arch`` and its seeded CPU weights, Mamba and
    xLSTM leaves widened (``lively``, ``lively_xlstm``)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M

    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    if "mamba" in cfg.layer_kinds():
        lively(cfg, params, seed)
    elif cfg.xlstm is not None:
        lively_xlstm(cfg, params, seed)
    return cfg, params


def parity_engine(cfg, params, mode: str, device):
    """``parity_sessions`` through the engine in a ``PARITY_MODES`` mode:
    the finished engine."""
    from repro_torch.core import domains as D
    from repro_torch.core import sched as Sched
    from repro_torch.core.adaptive import AdaptiveConfig
    from repro_torch.serving import engine as E
    from repro_torch.serving import session as S

    kw = dict(PARITY_MODES[mode])
    if mode == "inkernel_adaptive":
        kw["adaptive"] = AdaptiveConfig(high_frac=0.01, low_frac=0.0,
                                        cooldown_ms=50.0,
                                        watch=("/t/lo1", "/t/lo2"))
    # weighted slots exist only under the weighted-fair program
    prog = Sched.WeightedFairProgram() if "sched_slots" in kw else None
    return run_engine(E, cfg, params, parity_sessions(S, D),
                      E.EngineConfig(**PARITY_COMMON, **kw), device,
                      prog=prog)


def parity_run(eng) -> dict:
    """What engine_parity compares of a finished engine: its report, its
    sessions' greedy token streams and the retuner's actions."""
    return {"report": eng.report(),
            "tokens": {sid: x.out_tokens for sid, x in eng.sessions.items()},
            "actions": [(e.render(), e.t_ms) for e in eng._adaptive.events]
            if eng._adaptive is not None else []}


def engine_parity(dev, seed: int, refs: CpuRefs) -> dict:
    from repro_torch.models import model as M

    cfg, params = parity_model("llama3.2-3b", seed)
    gparams = to_device(params, dev)
    # decode logits, CPU against the card, over a few steps
    rng = np.random.default_rng(seed)
    states = {"cpu": M.decode_state(cfg, 4, 64, "cpu"),
              "cuda": M.decode_state(cfg, 4, 64, dev)}
    lengths = np.array([0, 3, 17, 40], np.int32)
    logit_err = 0.0
    for _ in range(4):
        tokens = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        lc, _ = M.decode_step(cfg, params, states["cpu"],
                              torch.from_numpy(tokens),
                              torch.from_numpy(lengths))
        lg, _ = M.decode_step(cfg, gparams, states["cuda"],
                              torch.from_numpy(tokens).to(dev),
                              torch.from_numpy(lengths).to(dev))
        logit_err = max(logit_err, (lg.cpu() - lc).abs().max().item())
        if not torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)):
            raise AssertionError("decode argmax differs between CPU and card")
        lengths = lengths + 1
    if not logit_err <= 1e-4:
        raise AssertionError(f"decode logits differ by {logit_err}")
    # each mode's report on the CPU (a worker's) and on the card; with
    # the retuner, its actions too
    reports = {}
    for mode in PARITY_MODES:
        rc = refs.get(f"parity:llama3.2-3b:{mode}")
        rg = parity_run(parity_engine(cfg, gparams, mode, dev))
        if rc["report"] != rg["report"] or rc["actions"] != rg["actions"]:
            raise AssertionError(f"{mode} runs differ:\n{rc}\n{rg}")
        reports[mode] = rg["report"]
    acts = rg["actions"]
    if not any(a.startswith("[agentcgroup] PRESSURE") for a, _ in acts):
        raise AssertionError("the adaptive retuner never acted")
    return {"logits_max_abs_err": logit_err, "reports": reports,
            "adaptive_actions": len(acts),
            "families": family_parity(dev, seed, refs)}


# the decoder families the engine serves beside llama3.2-3b
PARITY_FAMILIES = ("jamba-v0.1-52b", "xlstm-350m",
                   "llama4-maverick-400b-a17b", "pixtral-12b")
# xLSTM leaves widened from the schema's scales, where a block moves the
# residual stream by ~1e-7 (tests/test_torch_families.py::lively)
LIVELY_XLSTM = ("up", "conv_w", "wq", "wk", "wv", "w_i", "w_f", "down",
                "w_z", "w_o", "r_i", "r_f", "r_z", "r_o")


def lively_xlstm(cfg, params, seed: int) -> None:
    """Widen the xLSTM leaves of ``params`` in place (CPU tensors)."""
    g = torch.Generator().manual_seed(seed)
    for pos, kind in zip(params["groups"], cfg.layer_kinds()):
        if kind not in ("mlstm", "slstm"):
            continue
        mix = pos["mixer"]
        for name in LIVELY_XLSTM:
            if name in mix:
                mix[name].mul_(5.0)
        mix["b_i"].normal_(0.0, 1.0, generator=g)
        mix["b_f"].normal_(1.0, 1.0, generator=g)


def family_parity(dev, seed: int, refs: CpuRefs) -> dict:
    """The reduced f32 Jamba, xLSTM, llama4-maverick and pixtral-12b
    (Jamba's Mamba and xLSTM's leaves widened) on the CPU and on the card,
    from the same
    weights: decode logits within 1e-4 with the same argmax over 4 steps,
    then parity_sessions in inkernel mode: the same report and the same
    greedy token streams."""
    from repro_torch.models import model as M

    out = {}
    for arch in PARITY_FAMILIES:
        cfg, params = parity_model(arch, seed)
        gparams = to_device(params, dev)
        rng = np.random.default_rng(seed)
        states = {"cpu": M.decode_state(cfg, 4, 64, "cpu"),
                  "cuda": M.decode_state(cfg, 4, 64, dev)}
        lengths = np.array([0, 3, 17, 40], np.int32)
        err = 0.0
        for _ in range(4):
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, 4).astype(
                np.int32))
            lc, _ = M.decode_step(cfg, params, states["cpu"], tokens,
                                  torch.from_numpy(lengths))
            lg, _ = M.decode_step(cfg, gparams, states["cuda"], tokens.to(dev),
                                  torch.from_numpy(lengths).to(dev))
            err = max(err, (lg.cpu() - lc).abs().max().item())
            if not torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)):
                raise AssertionError(f"{arch}: decode argmax differs")
            lengths = lengths + 1
        if not err <= 1e-4:
            raise AssertionError(f"{arch}: decode logits differ by {err}")
        cpu = refs.get(f"parity:{arch}:inkernel")
        card = parity_run(parity_engine(cfg, gparams, "inkernel", dev))
        (rc, rg), (sc, sg) = ((cpu["report"], card["report"]),
                              (cpu["tokens"], card["tokens"]))
        if rc != rg:
            raise AssertionError(f"{arch} reports differ:\n{rc}\n{rg}")
        if sc != sg:
            raise AssertionError(f"{arch}: greedy token streams differ")
        if rg["freezes"] < 1 or rg["thaws"] < 1:
            raise AssertionError(f"{arch}: no freeze and thaw: {rg}")
        out[arch] = {"logits_max_abs_err": err, "report": rg,
                     "tokens": sum(len(t) for t in sg.values())}
    return out


def engine_full(dev, seed: int, refs: CpuRefs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import domains as D
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import session as S

    cfg = get_config("llama3.2-3b")
    ecfg = E.EngineConfig(**FULL_ENGINE)

    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    eng = E.Engine(cfg, params, ecfg=ecfg, seed=0, device=dev)
    sessions = full_sessions(S, D, seed)
    for s in sessions:
        eng.submit(s)
    view = eng.cg.device_view()
    step_ms, tokens, gated = [], 0, 0
    torch.cuda.synchronize()
    reset_launch_counts()
    while not eng.done():
        if eng.step_no >= 8000:
            raise AssertionError("full-width engine did not finish")
        before = sum(s.length for s in sessions)
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        tokens += max(0, sum(s.length for s in sessions) - before)
        # the gate on the live table: may each running slot advance next
        # step?  Checked against the host snapshot's chains.
        dom = [eng.sessions[sid].dom_idx if sid is not None else -1
               for sid in eng.slot_session]
        gate = view.gate(view.state, torch.tensor(dom, dtype=torch.int32,
                                                  device=dev),
                         eng.step_no).cpu().tolist()
        gated += sum(1 for x in gate if not x)
        if gate != _host_gate(eng.cg.snapshot(), dom, eng.step_no):
            raise AssertionError(f"gate disagrees with the table at step "
                                 f"{eng.step_no}")
    counts = launch_counts()
    steps = eng.step_no
    report = eng.report()
    want = {"fused_charge_batch": steps, "fused_slot_gate": steps,
            "decode_attention": cfg.n_layers * steps,
            "paged_decode_attention": 0, "flash_fwd": 0, "flash_bwd": 0,
            "ssd_scan": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    # the control reference: the same sessions at reduced width on the CPU
    ref = refs.get("engine_full")
    if report != ref:
        raise AssertionError(f"full-width report differs from the reduced "
                             f"CPU run:\n{report}\n{ref}")
    if report["completed"] != len(sessions) or report["freezes"] < 1 \
            or report["throttle_triggers"] < 1 or report["overshoot_pages"]:
        raise AssertionError(f"enforcement did not act as planned: {report}")
    vocab = cfg.padded_vocab
    if not all(0 <= t < vocab for s in sessions for t in s.out_tokens):
        raise AssertionError("sampled token out of the vocabulary")
    # finite logits of the full-width step at ragged lengths
    state = M.decode_state(cfg, 8, 64, dev)
    logits, _ = M.decode_step(
        cfg, params, state, torch.arange(8, device=dev, dtype=torch.int32),
        torch.tensor([0, 1, 5, 9, 17, 33, 50, 63], dtype=torch.int32,
                     device=dev))
    if tuple(logits.shape) != (8, vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("full-width logits are not finite")
    total_s = sum(step_ms) / 1e3
    return {"params": n_params, "init_s": init_s, "steps": steps,
            "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": float(np.percentile(step_ms, 95)),
            "tokens": tokens, "tokens_per_s": tokens / total_s,
            "gated_slot_steps": gated, "launches": counts,
            "report": report,
            "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def train_parity(dev, seed: int) -> dict:
    """Three train steps of the reduced f32 model (two layers, selective
    remat) on the card and on the CPU from the same weights and data."""
    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.perf import DEFAULT_PERF, replace
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = dataclasses.replace(reduced(get_config("llama3.2-3b")),
                              dtype="float32", n_layers=2)
    perf = replace(DEFAULT_PERF, remat="dots")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    losses = {}
    reset_launch_counts()
    for where in ("cpu", dev):
        params = to_device(M.init_params(
            cfg, torch.Generator().manual_seed(seed), device="cpu"), where)
        state = init_train_state(cfg, params, perf)
        step = make_train_step(cfg, perf, opt)
        data = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch=4,
                            seq=256, device=where)
        losses[str(where)] = []
        for i in range(3):
            params, state, m = step(params, state, data.at(i), i)
            losses[str(where)].append(float(m["loss"]))
    counts = launch_counts()
    if counts["flash_fwd"] != 3 * 2 * 2 or counts["flash_bwd"] != 3 * 2:
        raise AssertionError(f"train_parity launches {counts}")
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses[str(dev)]))
    if not err <= 1e-4:
        raise AssertionError(f"train losses differ by {err}: {losses}")
    return {"losses": losses, "max_abs_err": err,
            "launches": {k: counts[k] for k in ("flash_fwd", "flash_bwd")}}


TRAIN_FULL = ["--arch", "llama3.2-3b", "--shape", "train_4k", "--batch",
              "1", "--seq", "4096", "--steps", "8", "--ckpt-every", "0",
              "--device", "cuda", "--log-every", "1"]
TRAIN_WARM = 2


def train_trajectory(dev, seed: int) -> dict:
    """``trajectory.compare`` on the card: llama3.2-3b at full width cut
    to ``trajectory.LAYERS`` layers, from the same weights and batches in
    bf16 and in f32 through the flash kernels; the warmup steps held by
    ``trajectory.verdict``, and the flash launches the two runs imply."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training import trajectory as T

    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    runs = T.compare(T.model_config(), seed=seed, device=dev)
    seconds = time.perf_counter() - t
    counts = launch_counts()
    want = {"flash_fwd": len(T.RUNS) * 2 * T.LAYERS * T.STEPS,
            "flash_bwd": len(T.RUNS) * T.LAYERS * T.STEPS}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"trajectory launches {got}, expected {want}")
    if not all(np.isfinite(sum(runs.values(), []))):
        raise AssertionError(f"trajectory losses {runs}")
    held = T.verdict(runs)
    if held["over"]:
        raise AssertionError(
            f"bf16 losses drift from f32 beyond {T.REL_BAR} at steps "
            f"{held['over']}: {dict(runs, **held)}")
    return {"layers": T.LAYERS, "steps": T.STEPS, "seq": T.SEQ,
            "cpu_rel_drift": T.CPU_REL_DRIFT, "seconds": seconds,
            "launches": got, "runs": runs, **held}


def train_full(dev, seed: int) -> dict:
    """The port's training driver at full width.  With ``remat="dots"``
    every layer runs the flash forward twice (the step and the recompute
    in the backward) and the backward once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    cfg = get_config("llama3.2-3b")
    args = train.parse_args(TRAIN_FULL + ["--seed", str(seed)])
    torch.cuda.synchronize()
    reset_launch_counts()
    base = torch.cuda.memory_allocated(dev)
    report = train.run(args)
    counts = launch_counts()
    losses = report["losses"]
    if len(losses) != args.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train_full losses {losses}")
    # random weights: tied embeddings of std 0.02 against unit-RMS final
    # activations give logits of variance d * 0.02**2, so the first CE is
    # ln V + var / 2, plus the 1e-4 z-loss of that log-partition
    var = cfg.d_model * 0.02 ** 2
    logz = float(np.log(cfg.padded_vocab)) + var / 2
    expect = logz + 1e-4 * logz ** 2
    if not abs(losses[0] - expect) <= 0.5:
        raise AssertionError(f"first loss {losses[0]}, expected {expect}")
    want = {"flash_fwd": 2 * cfg.n_layers * args.steps,
            "flash_bwd": cfg.n_layers * args.steps}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"train_full launches {got}, expected {want}")
    timed = report["step_s"][TRAIN_WARM:]
    p50 = statistics.median(timed)
    return {"steps": args.steps, "timed_steps": len(timed),
            "step_s": report["step_s"], "step_s_p50": p50,
            "tokens_per_s": report["tokens_per_step"] / p50,
            "peak_memory_gb": report["peak_memory_gb"],
            "allocated_at_start_gb": base / 1e9, "losses": losses,
            "first_loss_expected": expect,
            "ln_padded_vocab": float(np.log(cfg.padded_vocab)),
            "launches": got, "trajectory": train_trajectory(dev, seed)}


JAMBA = "jamba-v0.1-52b"
# Mamba leaves widened from the schema's std 0.02, so that each Mamba block
# moves the residual stream (at the schema's scales the gated norm's eps
# swamps their activations and they add ~1e-5)
LIVELY = {"in_proj": 5.0, "conv_w": 25.0, "x_to_bc": 6.0, "x_to_dt": 5.0}


def lively(cfg, params, seed: int) -> None:
    """Widen the Mamba leaves of ``params`` in place (CPU tensors)."""
    g = torch.Generator().manual_seed(seed)
    for pos, kind in zip(params["groups"], cfg.layer_kinds()):
        if kind != "mamba":
            continue
        mix = pos["mixer"]
        for name, f in LIVELY.items():
            mix[name].mul_(f)
        mix["a_log"].normal_(0.0, 0.5, generator=g)
        mix["dt_bias"].normal_(0.0, 1.0, generator=g)
        mix["d_skip"].normal_(1.0, 0.5, generator=g)


def prefill_parity(dev, seed: int) -> dict:
    """The reduced f32 Jamba (one group: 7 Mamba layers, 1 attention, 4
    MoE) forward on the card through the kernels and on the CPU through
    their plain versions, from the same weights and tokens: logits within
    1e-4 with the same argmax, aux within 1e-6."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.perf import DEFAULT_PERF, replace

    cfg = dataclasses.replace(reduced(get_config(JAMBA)), dtype="float32")
    perf = replace(DEFAULT_PERF, scan_chunk=32)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    lively(cfg, params, seed)
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        want, want_aux = M.forward(cfg, params, {"tokens": tokens},
                                   perf=perf)
        gparams = to_device(params, dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        got, aux = M.forward(cfg, gparams, {"tokens": tokens.to(dev)},
                             perf=perf)
        torch.cuda.synchronize()
        counts = launch_counts()
    kinds = cfg.layer_kinds()
    expect = {"ssd_scan": kinds.count("mamba"), "flash_fwd": kinds.count(
        "attn")}
    if {k: counts[k] for k in expect} != expect or \
            sum(counts.values()) != sum(expect.values()):
        raise AssertionError(f"prefill_parity launches {counts}")
    err = (got.cpu() - want).abs().max().item()
    aux_err = abs(float(aux) - float(want_aux))
    same_argmax = torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    if not (err <= 1e-4 and aux_err <= 1e-6 and same_argmax):
        raise AssertionError(f"prefill parity: logits {err}, aux {aux_err}, "
                             f"argmax same {same_argmax}")
    return {"logits_max_abs_err": err, "aux_abs_err": aux_err,
            "aux": float(want_aux), "launches": expect}


PREFILL_LAYERS = 8
PREFILL_TIMED = 3
PREFILL_CE_ROWS = 4096


def prefill_full(dev, seed: int) -> dict:
    """``models/model.py::forward`` under ``torch.inference_mode()``, as
    the reference's ``launch/dryrun.py::prefill_step`` lowers it, on the
    full-width jamba-v0.1-52b cut to one 8-layer group (7 Mamba, 1
    attention, MoE every other layer; bf16, random weights from a seeded
    generator on the card) at prefill_32k's sequence of 32768, batch 1:
    one untimed prefill, then ``PREFILL_TIMED`` timed ones, each through
    7 SSD launches and 1 flash-forward launch; finite logits; the mean
    next-token cross-entropy where random weights put it; the flash
    forward alone at the prefill shape, out and lse against the plain
    version (``flash_close``), and its time beside the library call's."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import ref as R
    from repro_torch.models import model as M
    from repro_torch.models import moe as MoE
    from repro_torch.models.layers import cross_entropy
    from repro_torch.perf import DEFAULT_PERF

    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, n_layers=PREFILL_LAYERS)
    seq = SHAPES["prefill_32k"].seq_len
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (1, seq), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed + 1))
    kinds = cfg.layer_kinds()
    expect = {"ssd_scan": kinds.count("mamba") * cfg.n_groups,
              "flash_fwd": kinds.count("attn") * cfg.n_groups}
    torch.cuda.reset_peak_memory_stats(dev)
    prefill_s, drops = [], None
    with torch.inference_mode():
        for i in range(1 + PREFILL_TIMED):
            MoE.drop_log = [] if i == 0 else None
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            logits, aux = M.forward(cfg, params, {"tokens": tokens})
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = launch_counts()
            if {k: counts[k] for k in expect} != expect or \
                    sum(counts.values()) != sum(expect.values()):
                raise AssertionError(f"prefill launches {counts}, expected "
                                     f"{expect}")
            if i == 0:
                drops = [int(n) for n in MoE.drop_log]
                MoE.drop_log = None
            else:
                prefill_s.append(dt)
            if i < PREFILL_TIMED:
                del logits
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        vocab = cfg.padded_vocab
        if tuple(logits.shape) != (1, seq, vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        # next-token cross-entropy (with the loss's z-loss), in row chunks
        rows = logits[0, :-1]
        labels = tokens[0, 1:]
        total = 0.0
        for r0 in range(0, rows.shape[0], PREFILL_CE_ROWS):
            part = rows[r0:r0 + PREFILL_CE_ROWS]
            n = part.shape[0]
            total += float(cross_entropy(
                part[None], labels[None, r0:r0 + n],
                torch.ones(1, n, device=dev))) * n
        ce = total / rows.shape[0]
        del logits, rows
    # random weights: the untied std-0.02 head against unit-RMS final
    # activations gives logits of variance d * 0.02**2, so the CE is
    # ln V + var / 2 plus the 1e-4 z-loss of that log-partition
    var = cfg.d_model * 0.02 ** 2
    logz = float(np.log(vocab)) + var / 2
    ce_expect = logz + 1e-4 * logz ** 2
    if not abs(ce - ce_expect) <= 0.5:
        raise AssertionError(f"prefill cross-entropy {ce}, expected "
                             f"{ce_expect}")
    # the flash forward alone at the prefill shape: held against its
    # plain version element by element, then timed beside the library call
    hd = cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    q = torch.randn(1, seq, cfg.n_heads, hd, generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, seq, cfg.n_kv_heads, hd, generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    out, lse = FA.flash_fwd(q, k, v, causal=True)
    want_out, want_lse = R.flash_fwd(q, k, v, causal=True)
    fwd_errs = {"out": flash_close(out, want_out, torch.bfloat16),
                "lse": flash_close(lse, want_lse, torch.bfloat16)}
    del out, lse, want_out, want_lse
    if not all(e["ok"] for e in fwd_errs.values()):
        raise AssertionError(f"flash forward at the prefill shape: "
                             f"{fwd_errs} over {ATTN_TOL[torch.bfloat16]}")
    fwd_ms = cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=True), 5, 2)
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 5, 2)
    fwd_ops = FA.cost(q, k, v, causal=True)["ops"]
    p50 = statistics.median(prefill_s)
    return {"config": cfg.name, "layers": cfg.n_layers, "seq": seq,
            "batch": 1, "params": n_params, "init_s": init_s,
            "reduced": {"n_layers": f"{full.n_layers} -> {cfg.n_layers}: "
                        "the 51.4 B parameters are 103 GB in bf16, over the "
                        "card's 80 GB; one full 7:1 group",
                        "global_batch": f"{SHAPES['prefill_32k'].global_batch}"
                        " -> 1: one card"},
            "prefill_s": prefill_s, "prefill_s_p50": p50,
            "prefill_s_p95": float(np.percentile(prefill_s, 95)),
            "tokens_per_s": seq / p50, "peak_memory_gb": peak_gb,
            "allocated_at_start_gb": base / 1e9,
            "launches_per_prefill": expect,
            "moe_dropped_per_layer": drops,
            "moe_capacity": MoE.capacity(cfg, seq,
                                         DEFAULT_PERF.capacity_factor),
            "aux": float(aux), "cross_entropy": ce,
            "cross_entropy_expected": ce_expect,
            "flash_fwd_prefill_errs": fwd_errs,
            "flash_fwd_prefill_ms": fwd_ms,
            "flash_fwd_prefill_tflops": fwd_ops / fwd_ms / 1e9,
            "flash_fwd_prefill_library_ms": lib_ms}


def frontend_parity(dev, seed: int) -> dict:
    """The reduced f32 hubert-xlarge (two layers, MHA, bidirectional,
    ``remat="dots"``) trained 3 steps on the card through the flash
    kernels and 3 on the CPU through their plain versions, from the same
    weights and masked-frame batches: losses within 1e-4.  The reduced f32
    pixtral-12b forward with patches on both, from the same weights and
    batch: logits within 1e-4 with the same argmax."""
    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.perf import DEFAULT_PERF, replace
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = dataclasses.replace(reduced(get_config("hubert-xlarge")),
                              dtype="float32", n_layers=2)
    perf = replace(DEFAULT_PERF, remat="dots")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    losses = {}
    reset_launch_counts()
    for where in ("cpu", dev):
        params = to_device(M.init_params(
            cfg, torch.Generator().manual_seed(seed), device="cpu"), where)
        state = init_train_state(cfg, params, perf)
        step = make_train_step(cfg, perf, opt)
        data = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch=4,
                            seq=256, device=where)
        losses[str(where)] = []
        for i in range(3):
            params, state, m = step(params, state, data.at(i), i)
            losses[str(where)].append(float(m["loss"]))
    counts = launch_counts()
    if counts["flash_fwd"] != 3 * 2 * 2 or counts["flash_bwd"] != 3 * 2:
        raise AssertionError(f"hubert parity launches {counts}")
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses[str(dev)]))
    if not err <= 1e-4:
        raise AssertionError(f"hubert losses differ by {err}: {losses}")
    out = {"hubert_losses": losses, "hubert_max_abs_err": err}
    pcfg = dataclasses.replace(reduced(get_config("pixtral-12b")),
                               dtype="float32")
    params = M.init_params(pcfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    batch = DataIterator(pcfg, SHAPES["train_4k"], seed=seed, batch=2,
                         seq=64, device="cpu").at(0)
    with torch.inference_mode():
        want, _ = M.forward(pcfg, params, batch)
        gparams, gbatch = to_device(params, dev), to_device(batch, dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        got, _ = M.forward(pcfg, gparams, gbatch)
        torch.cuda.synchronize()
        counts = launch_counts()
    if counts["flash_fwd"] != pcfg.n_layers or sum(counts.values()) \
            != pcfg.n_layers:
        raise AssertionError(f"pixtral parity launches {counts}")
    perr = (got.cpu() - want).abs().max().item()
    if not (perr <= 1e-4 and torch.equal(got.argmax(-1).cpu(),
                                          want.argmax(-1))):
        raise AssertionError(f"pixtral forward logits differ by {perr}")
    out["pixtral_logits_max_abs_err"] = perr
    return out


HUBERT_TRAIN = ["--arch", "hubert-xlarge", "--shape", "train_4k", "--batch",
                "1", "--seq", "4096", "--steps", "8", "--ckpt-every", "0",
                "--device", "cuda", "--log-every", "1"]
PIXTRAL_TIMED = 3


def _random_ce(cfg) -> float:
    """Where random weights put the cross-entropy: a std-0.02 head against
    unit-RMS final activations gives logits of variance d * 0.02**2, so
    the CE is ln V + var / 2, plus the loss's 1e-4 z-loss of that
    log-partition."""
    logz = float(np.log(cfg.padded_vocab)) + cfg.d_model * 0.02 ** 2 / 2
    return logz + 1e-4 * logz ** 2


def hubert_train_full(dev, seed: int) -> dict:
    """``launch.train --arch hubert-xlarge`` at full width (48 layers, d
    1280, bf16, seeded random weights on the card), train_4k's sequence
    of 4096 frames at batch 1, the masked-frame loss, ``remat="dots"``,
    8 steps (2 untimed): ``train_run_full``'s checks."""
    return train_run_full(HUBERT_TRAIN, seed)


# pixtral-12b trained at full width on the card (d 160's flash backward),
# cut in depth: 4.20 B parameters at 12 bytes each (bf16 weights and
# gradients, AdamW's f32 moments) are ~50 GB; the 40 layers' 12.7 B would
# be ~153 GB
PIXTRAL_LAYERS = 10
PIXTRAL_TRAIN = ["--arch", "pixtral-12b", "--layers", str(PIXTRAL_LAYERS),
                 "--shape", "train_4k", "--batch", "1", "--seq", "4096",
                 "--steps", "8", "--ckpt-every", "0", "--device", "cuda",
                 "--log-every", "1"]
PIXTRAL_CUT = ("40 -> 10 layers at full width: 4.20 B parameters at 12 "
               "bytes (weights, gradients, AdamW's f32 moments) are ~50 GB")


def pixtral_train_full(dev, seed: int) -> dict:
    """``launch.train --arch pixtral-12b --layers 10`` at full width (d
    5120, 32 / 8 heads of 160, bf16, ``remat="dots"``), train_4k's 4096
    positions (1,024 of them patches) at batch 1, 8 steps (2 untimed):
    ``train_run_full``'s checks, the flash backward at d 160 once a layer
    a step."""
    return dict(train_run_full(PIXTRAL_TRAIN, seed), cut=PIXTRAL_CUT)


def train_run_full(argv: list, seed: int) -> dict:
    """``launch.train`` with ``argv`` on the card: finite losses, the
    first where random weights put it (``_random_ce``), and the flash
    launches the layers imply (the forward twice a layer a step under
    dots remat, the backward once); step p50, tokens/s, peak memory."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train

    args = train.parse_args(argv + ["--seed", str(seed)])
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dc.replace(cfg, n_layers=args.layers)
    torch.cuda.synchronize()
    reset_launch_counts()
    base = torch.cuda.memory_allocated()
    with contextlib.redirect_stdout(io.StringIO()):
        report = train.run(args)
    counts = launch_counts()
    losses = report["losses"]
    if len(losses) != args.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{args.arch} train losses {losses}")
    expect = _random_ce(cfg)
    if not abs(losses[0] - expect) <= 0.5:
        raise AssertionError(f"{args.arch} first loss {losses[0]}, "
                             f"expected {expect}")
    want = {k: 0 for k in counts}
    want.update(flash_fwd=2 * cfg.n_layers * args.steps,
                flash_bwd=cfg.n_layers * args.steps)
    if counts != want:
        raise AssertionError(f"{args.arch} train launches {counts}, "
                             f"expected {want}")
    timed = report["step_s"][TRAIN_WARM:]
    p50 = statistics.median(timed)
    return {"args": argv, "layers": cfg.n_layers,
            "params": cfg.param_count(), "timed_steps": len(timed),
            "step_s": report["step_s"], "step_s_p50": p50,
            "tokens_per_s": report["tokens_per_step"] / p50,
            "peak_memory_gb": report["peak_memory_gb"],
            "allocated_at_start_gb": base / 1e9, "losses": losses,
            "first_loss_expected": expect, "launches": counts}


def pixtral_forward_full(dev, seed: int) -> dict:
    """``models/model.py::forward`` under ``torch.inference_mode()`` on
    the full-width pixtral-12b (40 layers, d 5120, bf16, seeded random
    weights on the card) over train_4k's batch of one 4096-token
    sequence whose first 1,024 positions are patch embeddings (the data
    pipeline's vision batch): one untimed and ``PIXTRAL_TIMED`` timed
    calls, each 40 d-160 flash-forward launches; finite logits and the
    cross-entropy of the text positions where random weights put it."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models.layers import cross_entropy

    cfg = get_config("pixtral-12b")
    seq = SHAPES["train_4k"].seq_len
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch=1,
                         seq=seq, device=dev).at(0)
    n = batch["patches"].shape[1]
    torch.cuda.reset_peak_memory_stats(dev)
    forward_s = []
    with torch.inference_mode():
        for i in range(1 + PIXTRAL_TIMED):
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            logits, _ = M.forward(cfg, params, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = launch_counts()
            if counts["flash_fwd"] != cfg.n_layers or \
                    sum(counts.values()) != cfg.n_layers:
                raise AssertionError(f"pixtral forward launches {counts}")
            if i:
                forward_s.append(dt)
            if i < PIXTRAL_TIMED:
                del logits
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if tuple(logits.shape) != (1, seq, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("pixtral logits are not finite")
        ce = float(cross_entropy(logits, batch["labels"], batch["weights"]))
        del logits
    expect = _random_ce(cfg)
    if not abs(ce - expect) <= 0.5:
        raise AssertionError(f"pixtral text cross-entropy {ce}, expected "
                             f"{expect}")
    if batch["weights"][:, :n].any():
        raise AssertionError("loss weight on a patch position")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    p50 = statistics.median(forward_s)
    return {"layers": cfg.n_layers, "seq": seq, "patches": n,
            "params": n_params, "init_s": init_s, "forward_s": forward_s,
            "forward_s_p50": p50, "tokens_per_s": seq / p50,
            "peak_memory_gb": peak_gb, "allocated_at_start_gb": base / 1e9,
            "cross_entropy": ce, "cross_entropy_expected": expect,
            "launches": counts}


def frontends_full(dev, seed: int) -> dict:
    """The frontend families on the card: ``frontend_parity``,
    ``hubert_train_full``, ``pixtral_forward_full`` and
    ``pixtral_train_full``."""
    import gc

    out = {"frontend_parity": frontend_parity(dev, seed)}
    for name, fn in (("hubert_train_full", hubert_train_full),
                     ("pixtral_forward_full", pixtral_forward_full),
                     ("pixtral_train_full", pixtral_train_full)):
        out[name] = fn(dev, seed)
        gc.collect()
        torch.cuda.empty_cache()
    return out


DEEPSEEK = "deepseek-v2-236b"
# deepseek-v2-236b's forward on the card: 60 -> 4 layers (families_full's
# cut), one 4096-token sequence
DEEPSEEK_LAYERS = 4
DEEPSEEK_TIMED = 3


def mla_parity(dev, seed: int) -> dict:
    """The MLA model on the card against the port's CPU run: the flash
    kernels take MLA's published (192, 128) and not the reduced config's
    (48, 32), so the model is the reduced f32 deepseek with the real head
    dims (nope 128, rope 64, v 128; d 128, 4 heads, a 32-wide latent,
    top 2 of 4 experts plus 2 shared).  Its forward from the same weights
    and tokens through the f32 kernels and through their plain versions:
    logits within 1e-4 (the f32 kernels hold 2e-5 a call) with the same
    argmax, aux within 1e-6; one flash launch a layer.  Then three decode
    steps (torch on both) from a cache the forward's tokens filled
    step by step: logits within 1e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M

    small = reduced(get_config(DEEPSEEK))
    cfg = dataclasses.replace(small, dtype="float32", mla=dataclasses.replace(
        small.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128))
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        want, want_aux = M.forward(cfg, params, {"tokens": tokens})
        gparams = to_device(params, dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        got, aux = M.forward(cfg, gparams, {"tokens": tokens.to(dev)})
        torch.cuda.synchronize()
        counts = launch_counts()
        steps = {}
        for where, p in (("cpu", params), ("card", gparams)):
            d = "cpu" if where == "cpu" else dev
            state = M.decode_state(cfg, 2, 64, device=d)
            out = []
            for i in range(3):
                lg, state = M.decode_step(
                    cfg, p, state, tokens[:, i].to(d),
                    torch.full((2,), i, dtype=torch.int32, device=d))
                out.append(lg.cpu())
            steps[where] = out
    want_counts = {k: 0 for k in counts}
    want_counts["flash_fwd"] = cfg.n_layers
    if counts != want_counts:
        raise AssertionError(f"mla_parity launches {counts}")
    err = (got.cpu() - want).abs().max().item()
    aux_err = abs(float(aux) - float(want_aux))
    same = torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    dec_err = max((a - b).abs().max().item()
                  for a, b in zip(steps["cpu"], steps["card"]))
    if not (err <= 1e-4 and aux_err <= 1e-6 and same and dec_err <= 1e-4):
        raise AssertionError(f"mla parity: logits {err}, aux {aux_err}, "
                             f"argmax same {same}, decode {dec_err}")
    return {"head_dims": M.head_dims(cfg), "logits_max_abs_err": err,
            "aux_abs_err": aux_err, "decode_max_abs_err": dec_err,
            "tolerance": 1e-4, "launches": counts}


def deepseek_forward_full(dev, seed: int) -> dict:
    """``models/model.py::forward`` under ``torch.inference_mode()`` on
    the full-width deepseek-v2-236b (d 5120, 128 heads at dk 192 / dv
    128, a 512-wide latent, 160 experts top 6 plus 2 shared, bf16, seeded
    random weights on the card) cut to ``DEEPSEEK_LAYERS`` layers, over
    one 4096-token sequence: one untimed and ``DEEPSEEK_TIMED`` timed
    calls, each one flash-forward launch a layer and nothing else; finite
    logits, and the next-token cross-entropy where random weights put
    it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models.layers import cross_entropy

    cfg = dataclasses.replace(get_config(DEEPSEEK), n_layers=DEEPSEEK_LAYERS)
    seq = 4096
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (1, seq + 1), generator=g,
                           device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    forward_s = []
    with torch.inference_mode():
        for i in range(1 + DEEPSEEK_TIMED):
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            logits, aux = M.forward(cfg, params, {"tokens": tokens[:, :-1]})
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = launch_counts()
            if counts["flash_fwd"] != cfg.n_layers or \
                    sum(counts.values()) != cfg.n_layers:
                raise AssertionError(f"deepseek forward launches {counts}")
            if i:
                forward_s.append(dt)
            if i < DEEPSEEK_TIMED:
                del logits
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if tuple(logits.shape) != (1, seq, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("deepseek logits are not finite")
        ce = float(cross_entropy(logits, tokens[:, 1:],
                                 torch.ones(1, seq, device=dev)))
        del logits
    expect = _random_ce(cfg)
    if not abs(ce - expect) <= 0.5:
        raise AssertionError(f"deepseek cross-entropy {ce}, expected "
                             f"{expect}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    p50 = statistics.median(forward_s)
    return {"layers": cfg.n_layers, "of_layers": get_config(DEEPSEEK).n_layers,
            "seq": seq, "params": n_params, "init_s": init_s,
            "forward_s": forward_s, "forward_s_p50": p50,
            "tokens_per_s": seq / p50, "peak_memory_gb": peak_gb,
            "allocated_at_start_gb": base / 1e9,
            "cross_entropy": ce, "cross_entropy_expected": expect,
            "aux": float(aux), "launches": counts,
            "cut": FAMILIES_FULL[DEEPSEEK][1]}


def mla_decode_kernel(dev, seed: int) -> dict:
    """The latent decode kernel against its plain version at the serving
    cell's shape (128 slots x 128 heads, S_max 4096, random live rows):
    each slot within 1e-2 (Frobenius, relative), one launch a call; both
    timed on CUDA events beside the kernel's bound."""
    from repro_torch.kernels import mla_decode as MD

    B, H, S = 128, 128, 4096
    g = torch.Generator(device=dev).manual_seed(seed)
    ckv = torch.randn(B, S, 512, device=dev, generator=g).bfloat16()
    kr = torch.randn(B, S, 64, device=dev, generator=g).bfloat16()
    ql = (torch.randn(B, H, 512, device=dev, generator=g) / 22).bfloat16()
    qr = (torch.randn(B, H, 64, device=dev, generator=g) / 22).bfloat16()
    live = torch.randint(1, S + 1, (B,), device=dev, generator=g,
                         dtype=torch.int32)
    args = (ql, qr, ckv, kr, live)
    before = MD.mla_decode.launches
    got = MD.mla_decode(*args)
    want = MD.mla_decode_plain(*args)
    if MD.mla_decode.launches != before + 1:
        raise AssertionError("mla_decode: no launch counted")
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    rel = (d / want.float().flatten(1).norm(dim=1)).max().item()
    if not rel < 1e-2:
        raise AssertionError(f"mla_decode: slot error {rel}")

    def ms(fn, reps):
        fn(*args)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    c = MD.cost(B, H, 512, 64, live.tolist())
    bound = max(c["ops"] / 989e12, c["bytes"] / 3.35e12) * 1e3
    return {"slot_rel_err": rel, "kernel_ms": ms(MD.mla_decode, 20),
            "plain_ms": ms(MD.mla_decode_plain, 3), "bound_ms": bound}


def mla_full(dev, seed: int) -> dict:
    """MLA on the card: ``mla_parity``, ``mla_decode_kernel`` and
    ``deepseek_forward_full``."""
    import gc

    out = {"mla_parity": mla_parity(dev, seed),
           "mla_decode_kernel": mla_decode_kernel(dev, seed),
           "deepseek_forward_full": deepseek_forward_full(dev, seed)}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the dry run of each full-width run that measures a peak: the phase and
# its result's key, and the cell the dry run traces at that config,
# depth, batch and seq (``launch/dryrun.py::run_cell``)
DRYRUN_RUNS = {
    "train_full": ("train_full", None, "llama3.2-3b", "train_4k",
                   dict(batch=1, seq=4096)),
    "hubert_train_full": ("frontends_full", "hubert_train_full",
                          "hubert-xlarge", "train_4k",
                          dict(batch=1, seq=4096)),
    "pixtral_train_full": ("frontends_full", "pixtral_train_full",
                           "pixtral-12b", "train_4k",
                           dict(layers=PIXTRAL_LAYERS, batch=1, seq=4096)),
    "prefill_full": ("prefill_full", None, JAMBA, "prefill_32k",
                     dict(layers=PREFILL_LAYERS, batch=1)),
    "pixtral_forward_full": ("frontends_full", "pixtral_forward_full",
                             "pixtral-12b", "prefill_32k",
                             dict(batch=1, seq=4096)),
    "deepseek_forward_full": ("mla_full", "deepseek_forward_full", DEEPSEEK,
                              "prefill_32k",
                              dict(layers=DEEPSEEK_LAYERS, batch=1,
                                   seq=4096)),
}
DRYRUN_TOL = 0.10          # estimated peak against measured, relative


def dry_run(name: str) -> dict:
    """The dry run of ``DRYRUN_RUNS[name]`` on meta tensors (a
    ``CpuRefs`` worker runs it, no card)."""
    from repro_torch.launch import dryrun

    _, _, arch, shape, kw = DRYRUN_RUNS[name]
    return dryrun.run_cell(arch, shape, **kw)


def _step_launches(name: str, res: dict) -> dict:
    """A measured run's kernel launches a step (train) or a call."""
    if "launches_per_prefill" in res:
        return res["launches_per_prefill"]
    steps = len(res["step_s"]) if "step_s" in res else 1
    return {k: n // steps for k, n in res["launches"].items() if n}


def dryrun_phase(results: dict, refs: CpuRefs) -> dict:
    """Each measured run of ``DRYRUN_RUNS`` that ran (``results``: name
    -> its phase's result) against its dry run: the same step at the same
    config, depth, batch and seq, with the same remat and microbatches
    (train), the same kernel calls a step as the card launched, and an
    estimated peak within ``DRYRUN_TOL`` of the measured one
    (``max_memory_allocated`` less what was allocated when the run
    began).  Each run's estimated and measured GB, counted TFLOP, the
    roofline's step bound and the measured p50."""
    out = {}
    for name, res in results.items():
        rec = refs.get(f"dryrun:{name}")
        if "memory" not in rec:
            raise AssertionError(f"dry run of {name}: {rec}")
        est = rec["memory"]["per_device_bytes"] / 1e9
        meas = res["peak_memory_gb"] - res["allocated_at_start_gb"]
        calls = {k: v["launches"] for k, v in rec["kernels"].items()}
        p50 = next(res[k] for k in ("step_s_p50", "prefill_s_p50",
                                    "forward_s_p50") if k in res)
        out[name] = {
            "arch": rec["arch"], "shape": rec["shape"],
            "reduced": rec["reduced"], "estimated_gb": est,
            "measured_gb": meas, "rel_err": (est - meas) / meas,
            "at_peak_gb": {k: v / 1e9
                           for k, v in rec["memory"]["at_peak"].items()},
            "tflop": rec["costs"]["flops"] / 1e12,
            "bytes_gb": rec["costs"]["bytes"] / 1e9,
            "step_time_bound_s": rec["roofline"]["step_time_bound_s"],
            "dominant": rec["roofline"]["dominant"],
            "measured_p50_s": p50, "kernel_calls": calls,
            "t_trace_s": rec["t_trace_s"]}
        if rec["shape"] == "train_4k" and (
                rec["perf"]["remat"], rec["perf"]["microbatches"]) != (
                "dots", 1):
            raise AssertionError(f"dry run of {name} ran {rec['perf']}, "
                                 "the card's run remat dots, 1 microbatch")
        if calls != _step_launches(name, res):
            raise AssertionError(f"dry run of {name} calls {calls}, the "
                                 f"card launched {_step_launches(name, res)}")
        if not abs(est - meas) <= DRYRUN_TOL * meas:
            raise AssertionError(f"dry run of {name}: estimated peak "
                                 f"{est:.3f} GB, measured {meas:.3f} GB")
    return out


def profile_step(dev, seed: int, warm: int = 40, steps: int = 30) -> dict:
    """Where the full-width step's time goes: ``torch.profiler`` over
    ``steps`` engine steps after ``warm`` steps of the engine_full
    sessions — wall time, device busy time and the kernels that take
    it.  Not part of the default run."""
    from repro_torch.configs import get_config
    from repro_torch.core import domains as D
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import session as S

    cfg = get_config("llama3.2-3b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    eng = E.Engine(cfg, params, ecfg=E.EngineConfig(**FULL_ENGINE), seed=0,
                   device=dev)
    for s in full_sessions(S, D, seed):
        eng.submit(s)
    for _ in range(warm):
        eng.step()
    return _profile(eng.step, steps)


def train_profile(dev, seed: int, warm: int = 1, steps: int = 2) -> dict:
    """Where the full-width train step's time goes: ``torch.profiler``
    over ``steps`` steps of the train_full configuration after ``warm``
    steps.  Not part of the default run."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.models import model as M
    from repro_torch.perf import DEFAULT_PERF
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_config("llama3.2-3b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    opt = init_train_state(cfg, params, DEFAULT_PERF)
    step_fn = make_train_step(cfg, DEFAULT_PERF, OptConfig(total_steps=8,
                                                           warmup_steps=5))
    data = DataIterator(cfg, SHAPES["train_4k"], seed=seed, batch=1,
                        seq=4096, device=dev)
    batch = data.at(0)
    state = {"params": params, "opt": opt, "i": 0}

    def one_step():
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batch, state["i"])
        state["i"] += 1
        return float(m["loss"])

    for _ in range(warm):
        one_step()
    return _profile(one_step, steps)


def prefill_profile(dev, seed: int) -> dict:
    """Where the prefill_full configuration's time goes:
    ``torch.profiler`` over 2 prefills after one, with the SSD scan's
    kernels named whatever their rank.  Not part of the default run."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.ssd_ablation import KERNELS
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(JAMBA), n_layers=PREFILL_LAYERS)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, SHAPES["prefill_32k"].seq_len),
                           device=dev, generator=torch.Generator(device=dev)
                           .manual_seed(seed + 1))

    def prefill():
        with torch.inference_mode():
            M.forward(cfg, params, {"tokens": tokens})

    prefill()
    return _profile(prefill, 2, named=KERNELS)


def _profile(step, steps: int, named=()) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``step``: wall time,
    device busy time and idle share, the kernels that take most of it and
    each kernel whose name holds one of ``named``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]

    def row(e):
        return {"name": e.key[:90], "calls_per_step": e.count / steps,
                "ms_per_step": e.self_device_time_total / 1e3 / steps}

    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "cuda_launches_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [row(e) for e in top],
            "named_kernels": [row(e) for e in kernels
                              if any(f"::{n}(" in e.key for n in named)]}


# ------------------------------------------------ control plane, replay


CONFORMANCE_SIZES = (None, 4104)   # the kit's own size; the bench's beyond
# the card's kinds: (kind, shards); a sharded kind's 4,104 domains are 8
# device groups of 513 (the kernels' ``groups`` shard shape)
CONFORMANCE_KINDS = (("device", 1), ("sharded", 8), ("async-device", 1),
                     ("async-sharded", 8))


def conformance(dev, seed: int) -> dict:
    """The port's conformance suite on the card's backend kinds (the
    device table, the sharded table at 8 shards, and the async daemon
    around each), against the port's host tree, at the scenarios' size
    and at 4,104 domains; then the fault-injecting factories around the
    same kinds with the fault-free plan and with a transient-only plan
    under ``auto_retry=1``.  In every run each charge op reaches the
    fused charge once: charge launches equal charge ops."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.testing import conformance as K

    feats = K.backend_features("device")
    run = [s for s in K.STANDARD_SCENARIOS if s.requires <= feats]
    charges = sum(1 for s in run for op in s.ops if op[0] == "charge")
    suite = K.ConformanceSuite()
    out = {"scenarios": len(K.STANDARD_SCENARIOS), "run": len(run),
           "charge_ops": charges, "sizes": {}, "kinds": {}, "faulty": {}}

    def certify(factory) -> dict:
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        report = suite.run(factory, features=feats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        if not report.ok:
            raise AssertionError(report.summary())
        skipped = [r.name for r in report.results if r.skipped]
        if skipped != ["memcg_events"]:
            raise AssertionError(f"{factory.kind}: skipped {skipped}")
        want = {k: 0 for k in counts}
        want["fused_charge_batch"] = charges
        if counts != want:
            raise AssertionError(f"{factory.kind}: launches {counts}, "
                                 f"expected {want}")
        return {"passed": sum(1 for r in report.results
                              if r.ok and not r.skipped),
                "skipped": skipped, "launches": counts, "wall_s": wall}

    for kind, shards in CONFORMANCE_KINDS:
        for n in CONFORMANCE_SIZES:
            per = n // shards if n else None
            res = certify(K.standard_backend_factory(
                kind, device=dev, n_domains=per, n_shards=shards))
            size = str(n or run[0].n_domains)
            if kind == "device":          # the earlier slices' keys
                out["sizes"][size] = res
            out["kinds"][f"{kind}_s{shards}_n{size}"] = res
    plans = {"fault_free": (None, 0),
             "transient_retry": (FaultPlan(seed=seed + 7, p_transient=0.5),
                                 1)}
    for kind, shards in CONFORMANCE_KINDS:
        for name, (plan, retry) in plans.items():
            out["faulty"][f"{kind}_s{shards}_{name}"] = certify(
                K.faulty_backend_factory(kind, plan, auto_retry=retry,
                                         device=dev, n_shards=shards))
    return out


def replay_drivers(seed: int) -> dict:
    """The paper's four replay drivers as modules of the port, through
    its host tree, with the outcomes the reference tests assert."""
    from repro_torch.traces import (adaptive_pressure, escalation_waste,
                                    fig8_replay, replay_traces)

    out, times = {}, {}
    for name, fn in (("fig8", fig8_replay.run),
                     ("table2", replay_traces.main),
                     ("escalation_waste", escalation_waste.run),
                     ("adaptive_pressure", adaptive_pressure.run)):
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out[name] = fn()             # each driver asserts its own claims
        times[name] = time.perf_counter() - t
    f8 = out["fig8"]
    tight, mod = f8["tight"], f8["moderate"]
    checks = {
        "fig8 tight: agent survives, the baseline OOMs":
            tight["survival_agent"] == 1.0 and tight["survival_base"] < 1.0,
        "fig8 tight: the agent throttles": tight["throttle_triggers"] > 0,
        "fig8 moderate: HIGH P95 down >= 10 %, P50 within 1 ms":
            mod["high_p95_agent_ms"] < 0.9 * mod["high_p95_base_ms"]
            and abs(mod["high_p50_agent_ms"] - mod["high_p50_base_ms"]) < 1,
        "table2: only agentcgroup keeps every task":
            [r["policy"] for r in out["table2"] if r["survival"] == 1.0]
            == ["agentcgroup"],
        "escalation: recovers the calls the static limit kills":
            out["escalation_waste"]["survival_escalating"] == 1.0
            > out["escalation_waste"]["survival_static"]
            and out["escalation_waste"]["recovered_calls"]
            == out["escalation_waste"]["killed_calls"] > 0,
        "adaptive: fewer throttles, survival kept":
            out["adaptive_pressure"]["throttle_frac_adaptive"]
            < out["adaptive_pressure"]["throttle_frac_static"]
            and out["adaptive_pressure"]["adaptive"]["survival"]
            >= out["adaptive_pressure"]["static"]["survival"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"replay outcomes: {failed}\n{out}")
    return {"device": "none: host-side replay through the port's host "
                      "tree, no card", "results": out, "seconds": times,
            "checks": list(checks)}


SERVE_FULL = ["--arch", "llama3.2-3b", "--mode", "inkernel",
              "--sessions", "8", "--slots", "8", "--s-max", "2048",
              "--page-tokens", "16", "--pool-pages", "64",
              "--session-high", '{"s1": 8, "s3": 8, "s5": 8, "s7": 8}']


def gate_check(dev, gated: list, what: str):
    """An ``after_step`` hook: the gate read on the live table (may each
    running slot advance next step?) against the host snapshot's chains,
    the denied slots counted into ``gated[0]``."""
    def check(eng):
        view = eng.cg.device_view()
        dom = [eng.sessions[sid].dom_idx if sid is not None else -1
               for sid in eng.slot_session]
        gate = view.gate(view.state, torch.tensor(dom, dtype=torch.int32,
                                                  device=dev),
                         eng.step_no).cpu().tolist()
        gated[0] += sum(1 for x in gate if not x)
        if gate != _host_gate(eng.cg.snapshot(), dom, eng.step_no):
            raise AssertionError(f"{what}: gate disagrees with the table "
                                 f"at step {eng.step_no}")
    return check


def serve_full(dev, seed: int, refs: CpuRefs) -> dict:
    """``repro_torch.launch.serve`` at full width on the card, checked
    against the same sessions at reduced width on the CPU; the gate is
    read on the live table after each step (as engine_full does)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as SV

    args = SV.parser().parse_args(SERVE_FULL + ["--seed", str(seed)])
    ref = refs.get("serve")
    gated = [0]
    check_gate = gate_check(dev, gated, "serve_full")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng, timing = SV.serve(args, after_step=check_gate)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = eng.step_no
    report = eng.report()
    if not eng.done():
        raise AssertionError(f"serve did not finish in {steps} steps")
    want = {k: 0 for k in counts}
    want.update(fused_charge_batch=steps, fused_slot_gate=steps,
                decode_attention=eng.cfg.n_layers * steps)
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    if report != ref:
        raise AssertionError(f"full-width report differs from the reduced "
                             f"CPU run:\n{report}\n{ref}")
    if report["completed"] != args.sessions or report["freezes"] < 1 \
            or report["throttle_triggers"] < 1 or report["overshoot_pages"]:
        raise AssertionError(f"enforcement did not act as planned: {report}")
    if eng.cfg.d_model != 3072 or eng.cfg.n_layers != 28:
        raise AssertionError("serve_full did not run the full width")
    vocab = eng.cfg.padded_vocab
    if not all(0 <= x < vocab for s in eng.sessions.values()
               for x in s.out_tokens):
        raise AssertionError("sampled token out of the vocabulary")
    return {"args": SERVE_FULL, "steps": steps, "wall_s": wall,
            "step_ms_p50": timing["step_ms_p50"],
            "step_ms_p95": timing["step_ms_p95"],
            "tokens": timing["tokens"],
            "tokens_per_s": timing["tokens_per_s"],
            "gated_slot_steps": gated[0], "launches": counts,
            "report": report,
            "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


# each family's depth on one card (0: the config's own) and why it is cut
# the time the whole script may take (1,200 s with the build; 854-1,124
# s on one H100 80GB HBM3 at 700 W before the examples phase joined)
# cuts the dense families and xLSTM to 8 layers: their reports follow
# session phases, not depth, and the decode kernel runs at their heads
# at any depth
TIME_CUT = ("{} -> 8 layers: the examples and evaluation phases' ~270 s "
            "inside the script's 1,200 s on one card (whole scripts of "
            "1,016.6-1,424.8 s with the evaluation phase before this cut); "
            "the host-bound step takes ~1.1-1.7 ms a layer, and the report "
            "does not follow depth")
FAMILIES_FULL = {
    "phi3-medium-14b": (8, TIME_CUT.format(40)),
    "minicpm-2b": (8, TIME_CUT.format(40)),
    "internlm2-20b": (8, TIME_CUT.format(48)),
    "pixtral-12b": (8, TIME_CUT.format(40)),
    "llama4-maverick-400b-a17b": (
        2, "48 -> 2 layers: one dense + MoE group; the 128-expert MoE "
           "layer alone holds ~16.1 B parameters (~32 GB in bf16)"),
    "jamba-v0.1-52b": (
        8, "32 -> 8 layers: one 8-layer group, as prefill_full; the "
           "51.4 B parameters are ~103 GB in bf16"),
    "xlstm-350m": (8, TIME_CUT.format(24)),
    "deepseek-v2-236b": (
        4, "60 -> 4 layers: each MLA + 160-expert MoE layer holds ~3.9 B "
           "parameters; 4 layers and the embeddings are 16.94 B (~34 GB in "
           "bf16), the 236 B ~472 GB"),
}


def _slot_leaves(state, slot):
    return [t[:, slot].clone() for pos in state for t in pos.values()]


# the length ``check_recurrent_slots`` steps at: the attention row it writes
ROW = 5


def _row_moved(a, b) -> bool:
    """An attention leaf of one slot, (group, S_max, ...), before (``a``)
    and after (``b``) a granted step: row ``ROW`` rewritten, every other
    row bit-identical."""
    rest = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
    rest[ROW] = False
    return not torch.equal(a[:, ROW], b[:, ROW]) \
        and torch.equal(a[:, rest], b[:, rest])


def check_recurrent_slots(eng, dev, seed: int) -> dict:
    """On the card, with every state leaf filled from a seeded draw: a
    step whose gate denies slot 0 and grants slot 1 leaves slot 0's whole
    state bit-identical (GQA's k/v, MLA's latent ckv/krope, the recurrent
    states), moves every recurrent leaf of slot 1 and, in every attention
    leaf of slot 1, row ``ROW`` (the step's length) and no other; a slot
    frozen to host memory and thawed into another comes back
    bit-identical.  Runs after a served run (its launches not counted)."""
    caches, m = eng.caches, eng.ecfg.max_slots
    g = torch.Generator(device=dev).manual_seed(seed)
    for pos in caches.state:
        for t in pos.values():
            t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
    kinds = [k for k, pos in zip(eng.cfg.layer_kinds(), caches.state)
             for _ in pos]
    before = [_slot_leaves(caches.state, b) for b in (0, 1)]
    i32 = dict(dtype=torch.int32, device=dev)
    dom = torch.full((m,), -1, **i32)
    dom[1] = eng.cg.handle("/")
    gate = torch.zeros(m, dtype=torch.bool, device=dev)
    gate[1] = True
    _, _, granted, _ = eng._device_step(
        torch.arange(m, **i32), torch.full((m,), ROW, **i32), dom,
        torch.zeros(m, **i32), gate, False)
    torch.cuda.synchronize()
    if granted.cpu().tolist() != gate.cpu().tolist():
        raise AssertionError(f"gate {granted.tolist()}")
    kept = all(torch.equal(a, b) for a, b in
               zip(before[0], _slot_leaves(caches.state, 0)))
    after = _slot_leaves(caches.state, 1)
    moved = [not torch.equal(a, b) for a, b, k in
             zip(before[1], after, kinds) if k != "attn"]
    rows = [_row_moved(a, b) for a, b, k in zip(before[1], after, kinds)
            if k == "attn"]
    if not kept or not (moved or rows) or not all(moved + rows):
        raise AssertionError(f"denied slot kept {kept}, granted moved "
                             f"{moved}, granted attention rows {rows}")
    free = [caches.alloc_slot() for _ in range(caches.n_free)]
    want = _slot_leaves(caches.state, free[-1])
    for slot in free[:-1]:
        caches.free_slot(slot)
    caches.freeze_slot("probe", free[-1], pages=0)
    slot, _ = caches.thaw_slot("probe")
    got = _slot_leaves(caches.state, slot)
    thawed = slot != free[-1] and len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(want, got))
    if not thawed:
        raise AssertionError("a frozen-then-thawed slot's state differs")
    caches.free_slot(slot)
    return {"denied_slot_bit_identical": kept,
            "granted_recurrent_leaves_moved": len(moved),
            "granted_attention_leaves_row_only": len(rows),
            "freeze_thaw_bit_identical": thawed,
            "thaw_slot": (free[-1], slot)}


def families_full(dev, seed: int, refs: CpuRefs,
                  served: dict = None) -> dict:
    """``repro_torch.launch.serve`` on each family of ``FAMILIES_FULL`` at
    full width (bf16, random weights from a seeded generator on the
    card), over serve_full's 8 trace-derived sessions, slots, pool and
    LOW ``memory.high``: each report equal to the same config's reduced
    CPU run; the gate read on the live table after each step; one charge
    and one gate launch a step and a decode launch per attention layer a
    step (none for MLA: its latent decode is torch, as the reference's is
    lax).  On Jamba, xLSTM and deepseek-v2 (its latent rows),
    ``check_recurrent_slots``.  Step p50/p95,
    tokens/s and peak memory of each, beside serve_full's llama3.2-3b p50
    of this call.  Each model is freed before the next is built."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as SV

    out = {"cuts": {a: why for a, (_, why) in FAMILIES_FULL.items() if why},
           "serve_full_llama3.2-3b_step_ms_p50":
               served["step_ms_p50"] if served else None, "runs": {}}
    for arch, (layers, _) in FAMILIES_FULL.items():
        base = SERVE_FULL[2:] + ["--arch", arch, "--seed", str(seed)]
        ref = refs.get(f"family:{arch}")
        args = SV.parser().parse_args(
            base + (["--layers", str(layers)] if layers else []))
        gated = [0]
        check_gate = gate_check(dev, gated, arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng, timing = SV.serve(args, after_step=check_gate)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps, report, cfg = eng.step_no, eng.report(), eng.cfg
        full = get_config(arch)
        want = {k: 0 for k in counts}
        want.update(fused_charge_batch=steps, fused_slot_gate=steps,
                    decode_attention=decode_layers(cfg) * steps,
                    mla_decode=mla_layers(cfg) * steps)
        if counts != want:
            raise AssertionError(f"{arch}: launches {counts}, expected "
                                 f"{want}")
        if not eng.done() or report != ref:
            raise AssertionError(f"{arch}: full-width report differs from "
                                 f"the reduced CPU run:\n{report}\n{ref}")
        if report["freezes"] < 1 or report["throttle_triggers"] < 1 \
                or report["overshoot_pages"]:
            raise AssertionError(f"{arch}: enforcement did not act as "
                                 f"planned: {report}")
        if cfg.d_model != full.d_model or cfg.n_layers != (
                layers or full.n_layers) or cfg.dtype != full.dtype:
            raise AssertionError(f"{arch}: not the full width")
        if not all(0 <= x < cfg.padded_vocab for x_s in eng.sessions.values()
                   for x in x_s.out_tokens):
            raise AssertionError(f"{arch}: sampled token out of the "
                                 "vocabulary")
        run = {"layers": cfg.n_layers, "of_layers": full.n_layers,
               "params": sum(t.numel() for t in tree_leaves(eng.params)),
               "steps": steps, "wall_s": wall,
               "step_ms_p50": timing["step_ms_p50"],
               "step_ms_p95": timing["step_ms_p95"],
               "tokens_per_s": timing["tokens_per_s"],
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "decode_launches": counts["decode_attention"],
               "charge_launches": counts["fused_charge_batch"],
               "gated_slot_steps": gated[0], "launches": counts,
               "report_equals_serve_full": (served is not None
                                            and report == served["report"])}
        if cfg.mla is not None or any(k != "attn"
                                      for k in cfg.layer_kinds()):
            run["recurrent"] = check_recurrent_slots(eng, dev, seed)
        out["runs"][arch] = run
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_layers(cfg) -> int:
    """The decode kernel's launches a step: one per GQA attention layer;
    MLA decodes its latent cache with ``mla_layers``'s kernel."""
    if cfg.mla is not None:
        return 0
    return cfg.layer_kinds().count("attn") * cfg.n_groups


def mla_layers(cfg) -> int:
    """The latent decode kernel's launches a step: one per MLA layer in
    bf16 (an f32 latent cache decodes in torch)."""
    if cfg.mla is None or cfg.dtype != "bfloat16":
        return 0
    return cfg.layer_kinds().count("attn") * cfg.n_groups + cfg.first_dense


def _launches_as_steps(counts: dict, steps: int, cfg, what: str) -> None:
    """One charge launch a step (over every shard), the decode kernel a
    GQA layer a step, the latent decode kernel a bf16 MLA layer a step,
    nothing else."""
    want = {k: 0 for k in counts}
    want.update(fused_charge_batch=steps,
                decode_attention=decode_layers(cfg) * steps,
                mla_decode=mla_layers(cfg) * steps)
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


CONTROL_LAYERS = 4
CONTROL_CUT = ("28 -> 4 layers for the script's 1,200 s on one card, as "
               "families_full's cuts (the sharded run alone took ~106 s at "
               "28); the control planes' reports do not follow depth")


def control_full(dev, seed: int, refs: CpuRefs,
                 served: dict = None) -> dict:
    """The control planes beside the device table at full width
    (llama3.2-3b, bf16, random weights from a seeded generator on the
    card), each run against the same run at reduced width on the CPU:

      async     ``backend="async"`` on serve_full's trace-derived
                sessions: lifecycle ops in daemon epochs (epoch > 0); the
                report equal to the device backend's (the reduced CPU
                run's, and serve_full's when it ran);
      poisoned  the same with the daemon poisoned after step 40: one
                rebuild from the last step-boundary snapshot, full
                survival, no overshoot, root usage 0, the report equal
                to the reduced CPU run of the same schedule;
      sharded   ``backend="sharded"``, 2 shards, on engine_full's
                two-tenant sessions (``fg`` and ``bg`` each on its own
                device group): the report equal to the reduced CPU
                sharded run's.

    Every run at llama's full width cut to ``CONTROL_LAYERS`` layers
    (``CONTROL_CUT``): one charge launch a step for all its shards, a
    decode launch a layer a step, nothing else; step p50/p95 (host clock
    ending in a synchronize), printed and not asserted."""
    from repro_torch.configs import get_config
    from repro_torch.core import domains as D
    from repro_torch.core.daemon import AsyncDaemonBackend
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving import session as S

    args = SV.parser().parse_args(SERVE_FULL + [
        "--seed", str(seed), "--layers", str(CONTROL_LAYERS)])
    out = {"cut": CONTROL_CUT}
    device_ref = refs.get("serve")
    if served is not None and served != device_ref:
        raise AssertionError("serve_full's report differs from its reduced "
                             "CPU run")
    for name, hook in (("async", None), ("poisoned", poison_daemon)):
        ref = refs.get(name)
        if name == "async" and ref != device_ref:
            raise AssertionError(f"reduced async run differs from the "
                                 f"device run:\n{ref}\n{device_ref}")
        torch.cuda.synchronize()
        reset_launch_counts()
        eng, timing = SV.serve(args, after_step=hook, backend="async")
        counts = launch_counts()
        report = eng.report()
        be = eng.cg.backend
        if not isinstance(be, AsyncDaemonBackend) or be.epoch <= 0:
            raise AssertionError(f"{name}: lifecycle did not run in epochs")
        epoch = be.epoch
        usage = eng.cg.usage("/")
        eng.close()
        _launches_as_steps(counts, eng.step_no, eng.cfg, name)
        if report != ref or not eng.done():
            raise AssertionError(f"{name}: full-width report differs from "
                                 f"the reduced CPU run:\n{report}\n{ref}")
        want_rebuilds = 1 if hook else 0
        if eng.metrics.n_rebuilds != want_rebuilds or usage \
                or report["survival"] != 1.0 or report["overshoot_pages"]:
            raise AssertionError(f"{name}: rebuilds {eng.metrics.n_rebuilds}"
                                 f", root usage {usage}: {report}")
        out[name] = {"steps": eng.step_no, "epoch": epoch,
                     "rebuilds": eng.metrics.n_rebuilds,
                     "step_ms_p50": timing["step_ms_p50"],
                     "step_ms_p95": timing["step_ms_p95"],
                     "tokens_per_s": timing["tokens_per_s"],
                     "launches": counts, "report": report}
        del eng

    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=CONTROL_LAYERS)
    ecfg = E.EngineConfig(**FULL_ENGINE, backend="sharded", n_shards=2)
    ref = refs.get("sharded")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    eng = E.Engine(cfg, params, ecfg=ecfg, seed=0, device=dev)
    for sess in full_sessions(S, D, seed):
        eng.submit(sess)
    step_ms = []
    torch.cuda.synchronize()
    reset_launch_counts()
    while not eng.done():
        if eng.step_no >= 8000:
            raise AssertionError("the sharded engine did not finish")
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    counts = launch_counts()
    report = eng.report()
    _launches_as_steps(counts, eng.step_no, cfg, "sharded")
    placement = eng.cg.backend.placement()
    if placement != {"/fg": 0, "/bg": 1}:
        raise AssertionError(f"tenants not one a device group: {placement}")
    if report != ref:
        raise AssertionError(f"sharded: full-width report differs from the "
                             f"reduced CPU run:\n{report}\n{ref}")
    if report["completed"] != 8 or report["overshoot_pages"] \
            or eng.cg.usage("/"):
        raise AssertionError(f"sharded: {report}")
    out["sharded"] = {"steps": eng.step_no, "n_shards": 2,
                      "placement": placement,
                      "step_ms_p50": statistics.median(step_ms),
                      "step_ms_p95": float(np.percentile(step_ms, 95)),
                      "launches": counts, "report": report}
    return out


# ----------------------------------------------------------------- examples

# train_100m as the examples phase runs it: the source's defaults (300
# steps of the d-512, 8-layer model, batch 8, seq 256) with int8
# gradient compression; its checkpoints under build/
EXAMPLE_TRAIN = ["--grad-compress"]
EXAMPLE_CKPT = ROOT / "build" / "examples_train100m"
EXAMPLE_CPU_STEPS = 5        # train_100m steps the CPU run takes
EXAMPLE_REL = 1e-4           # losses, card against the CPU run, relative


def example_weights(name: str, seed: int) -> dict:
    """quickstart's or train_100m's weights, drawn on the CPU from a
    seeded generator (a card's generator draws other values) so that the
    card's run and the CPU run start from the same ones."""
    from repro_torch.examples import quickstart as QS
    from repro_torch.examples import train_100m as T100
    from repro_torch.models import model as M

    if name == "quickstart":
        cfg = QS.model_config()
    else:
        args = T100.parser().parse_args(EXAMPLE_TRAIN)
        cfg = T100.build_cfg(args.d_model, args.layers)
    return M.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def example_sections(text: str) -> dict:
    """quickstart's printed output by section header (``1``, ``1b``,
    ...)."""
    return {part.split(".", 1)[0]: part
            for part in ("\n" + text).split("\n== ")[1:]}


def example_reference(name: str, seed: int):
    """The port's CPU run an example on the card is held to: quickstart
    whole (what it returns and its printed text), serve_agents' reduced
    f32 run (each mode's report), train_100m's first
    ``EXAMPLE_CPU_STEPS`` losses from the same weights and batches."""
    from repro_torch.examples import quickstart as QS
    from repro_torch.examples import serve_agents as SA
    from repro_torch.examples import train_100m as T100

    if name == "quickstart":
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out = QS.main(["--device", "cpu"],
                          params=example_weights(name, seed))
        return dict(out, text=text.getvalue())
    if name == "serve_agents":
        return SA.main(["--device", "cpu", "--seed", str(seed)])
    args = T100.parser().parse_args(EXAMPLE_TRAIN + ["--device", "cpu"])
    params, opt, step, data = T100.trainer(
        args, torch.device("cpu"), example_weights(name, seed))
    losses = []
    for i in range(EXAMPLE_CPU_STEPS):
        params, opt, m = step(params, opt, data.at(i), i)
        losses.append(float(m["loss"]))
    return losses


def example_quickstart(dev, seed: int, refs: CpuRefs) -> dict:
    """``repro_torch.examples.quickstart`` on the card against its CPU
    run from the same weights: §1-§1c's lines equal, every §2 loss
    within ``EXAMPLE_REL`` relative (the f32 flash kernels against the
    plain f32 attention), §3's report equal; a charge launch for each
    device-table charge and engine step, a decode launch a layer a step,
    a flash forward and backward a layer a train step."""
    from repro_torch.examples import quickstart as QS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.trajectory import rel_drift

    params = to_device(example_weights("quickstart", seed), dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = QS.main(["--device", "cuda"], params=params)
    seconds = time.perf_counter() - t
    counts = launch_counts()
    ref = refs.get("example:quickstart")
    got, want = example_sections(text.getvalue()), \
        example_sections(ref["text"])
    for sec in ("1", "1b", "1c"):
        if got.get(sec) != want.get(sec):
            raise AssertionError(f"quickstart §{sec} differs from the CPU "
                                 f"run:\n{got.get(sec)}\n{want.get(sec)}")
    err = max(rel_drift(out["losses"], ref["losses"]))
    if not err <= EXAMPLE_REL:
        raise AssertionError(f"quickstart losses {out['losses']} against "
                             f"the CPU run's {ref['losses']}: {err}")
    if out["report"] != ref["report"]:
        raise AssertionError(f"quickstart §3 report differs from the CPU "
                             f"run:\n{out['report']}\n{ref['report']}")
    layers, steps = QS.model_config().n_layers, out["engine_steps"]
    expect = {k: 0 for k in counts}
    expect.update(fused_charge_batch=QS.DEVICE_CHARGES + steps,
                  decode_attention=layers * steps,
                  flash_fwd=10 * layers, flash_bwd=10 * layers)
    if counts != expect:
        raise AssertionError(f"quickstart launches {counts}, expected "
                             f"{expect}")
    return {"seconds": seconds, "losses": out["losses"],
            "cpu_losses": ref["losses"], "loss_rel_err": err,
            "engine_steps": steps, "report": out["report"],
            "launches": counts, "lines": text.getvalue().splitlines()}


def example_serve_agents(dev, seed: int, refs: CpuRefs) -> dict:
    """``repro_torch.examples.serve_agents --full`` on the card:
    llama3.2-3b at full width (28 layers, bf16, seeded weights on the
    card) serving the source's 5 sessions in each controller mode, each
    mode's report (its printed row included) equal to the reduced f32
    CPU run's, the agentcgroup row with every session done and no
    overshoot; 28 decode launches a step in every mode, a charge launch
    a step in agentcgroup only (the others account after the fact, in
    torch); step p50/p95 and tokens/s by mode."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_agents as SA
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as M

    args = SA.parser().parse_args(["--full", "--seed", str(seed)])
    cfg = SA.model_config(args.arch, full=True)
    if cfg != get_config("llama3.2-3b"):
        raise AssertionError("serve_agents --full is not llama3.2-3b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    ref = refs.get("example:serve_agents")
    out = {}
    for name in SA.MODES:
        eng = SA.engine(cfg, params, name, sessions=args.sessions,
                        pool_pages=args.pool_pages, seed=args.seed,
                        device=dev)
        sessions = list(eng.sessions.values())
        step_ms, tokens = [], 0
        torch.cuda.synchronize()
        reset_launch_counts()
        while not eng.done() and eng.step_no < SA.MAX_STEPS:
            before = sum(s.length for s in sessions)
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            tokens += max(0, sum(s.length for s in sessions) - before)
        counts = launch_counts()
        report, steps = eng.report(), eng.step_no
        row, want_row = SA.row(name, report), SA.row(name, ref[name])
        if row != want_row or report != ref[name]:
            raise AssertionError(f"serve_agents {name}: full-width report "
                                 f"differs from the reduced CPU run:\n"
                                 f"{row}\n{want_row}\n{report}\n{ref[name]}")
        expect = {k: 0 for k in counts}
        expect.update(decode_attention=cfg.n_layers * steps,
                      fused_charge_batch=steps if name == "agentcgroup"
                      else 0)
        if counts != expect:
            raise AssertionError(f"serve_agents {name}: launches {counts}, "
                                 f"expected {expect}")
        total_s = sum(step_ms) / 1e3
        out[name] = {"row": row, "steps": steps,
                     "step_ms_p50": statistics.median(step_ms),
                     "step_ms_p95": float(np.percentile(step_ms, 95)),
                     "tokens": tokens, "tokens_per_s": tokens / total_s,
                     "launches": counts, "report": report}
        del eng
    done = out["agentcgroup"]["report"]
    if done["completed"] != args.sessions or done["overshoot_pages"]:
        raise AssertionError(f"serve_agents agentcgroup: {done}")
    return {"header": SA.header(), "modes": out}


def example_train_100m(dev, seed: int, refs: CpuRefs) -> dict:
    """``repro_torch.examples.train_100m --grad-compress`` on the card at
    its defaults (the d-512 model, f32, 300 steps, a checkpoint every 100
    steps, the newest 2 kept): finite losses, the first
    ``EXAMPLE_CPU_STEPS`` within ``EXAMPLE_REL`` relative of the CPU run
    from the same weights and batches, the last below step 0's; each
    kept checkpoint restoring bit for bit (``ckpt.load``, the newest
    through ``restore_latest``) to a copy of the tree taken when it was
    saved; a flash forward and backward a layer a step."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.examples import train_100m as T100
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.trajectory import rel_drift

    copies, managers = {}, []
    base = T100.CheckpointManager

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            managers.append(self)

        def maybe_save(self, step, tree, *, force=False):
            saved = super().maybe_save(step, tree, force=force)
            if saved:
                copies[step] = tree_map(
                    lambda t: t.detach().to("cpu", copy=True), tree)
            return saved

    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    argv = EXAMPLE_TRAIN + ["--ckpt-dir", str(EXAMPLE_CKPT)]
    args = T100.parser().parse_args(argv)
    params = to_device(example_weights("train_100m", seed), dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    text = io.StringIO()
    T100.CheckpointManager = Kept
    try:
        with contextlib.redirect_stdout(text):
            out = T100.main(argv, params=params)
    finally:
        T100.CheckpointManager = base
    counts = launch_counts()
    losses = out["losses"]
    if len(losses) != args.steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train_100m losses {losses}")
    ref = refs.get("example:train_100m")
    err = max(rel_drift(losses[:EXAMPLE_CPU_STEPS], ref))
    if not err <= EXAMPLE_REL:
        raise AssertionError(f"train_100m losses {losses[:len(ref)]} "
                             f"against the CPU run's {ref}: {err}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_100m did not learn: {losses[0]} -> "
                             f"{losses[-1]}")
    (mgr,) = managers
    kept = mgr.steps()
    saved = [s for s in range(1, args.steps) if s % T100.CKPT_EVERY == 0]
    if kept != saved[-T100.CKPT_KEEP:] or not kept:
        raise AssertionError(f"train_100m kept checkpoints {kept}")
    for step in kept:
        at, tree = ckpt.load(mgr._path(step), copies[step])
        if at != step or not same_bits(tree, copies[step]):
            raise AssertionError(f"checkpoint {step} does not restore the "
                                 f"tree of its step")
    at, tree = mgr.restore_latest(copies[kept[-1]])
    if at != kept[-1] or not same_bits(tree, copies[at]):
        raise AssertionError("restore_latest does not give the newest tree")
    layers = args.layers
    expect = {k: 0 for k in counts}
    expect.update(flash_fwd=layers * args.steps, flash_bwd=layers * args.steps)
    if counts != expect:
        raise AssertionError(f"train_100m launches {counts}, expected "
                             f"{expect}")
    last = max(out["tokens_per_s"])
    return {"args": argv, "params": out["params"], "steps": args.steps,
            "seconds": out["seconds"],
            "tokens_per_s": out["tokens_per_s"][last],
            "peak_memory_gb": out["peak_memory_gb"],
            "losses_head": losses[:EXAMPLE_CPU_STEPS], "cpu_losses": ref,
            "loss_rel_err": err, "final_loss": losses[-1],
            "kept_steps": kept, "launches": counts,
            "lines": text.getvalue().splitlines()}


def same_bits(a, b) -> bool:
    """Two trees of tensors with the same paths, dtypes and bytes."""
    from torch.utils._pytree import tree_flatten_with_path

    fa, fb = tree_flatten_with_path(a)[0], tree_flatten_with_path(b)[0]
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x.reshape(-1).view(torch.uint8),
                                           y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(fa, fb))


def examples(dev, seed: int, refs: CpuRefs) -> dict:
    """The three example twins on the card (``repro_torch.examples``),
    each against its CPU run."""
    t = time.perf_counter()
    out = {"quickstart": example_quickstart(dev, seed, refs),
           "serve_agents": example_serve_agents(dev, seed, refs),
           "train_100m": example_train_100m(dev, seed, refs)}
    return dict(out, seconds=time.perf_counter() - t)


# -------------------------------------------------------------- evaluation

EVAL_DRYRUN = ROOT / "build" / "evaluation_dryrun"
EVAL_OVERHEAD = dict(steps=60, quick=True, backend="async")   # CI's smoke
EVAL_WARM = 5                # engine_overhead's untimed steps a run
SUITE_OVERHEAD_STEPS = 200   # the suite's engine_overhead, cut from 400
SUITE_GATE_ITERS = 60        # its fused-kernel gate's calls, cut from 300
SUITE_CUT = ("the suite's engine_overhead 400 -> 200 timed steps a run and "
             "its fused-kernel gate (no assert in the suite) 300 -> 60 "
             "calls a side: whole scripts of 1,016.6-1,424.8 s with 400 and "
             "300 (the plain charge ~150 ms a call)")
OVERHEAD_RUNS = ("off", "core", "full", "async")   # engine_overhead's runs
FIG8_RUNS = ("nolimit", "userspace", "agentcgroup")
HOST_SECTIONS = ("characterization", "mismatch", "fig8_replay",
                 "escalation_waste", "adaptive_pressure")
HOST_HEADERS = ("characterization", "mismatch analysis", "Fig 8 trace",
                "Semantic OOM", "Pressure-adaptive", "live-engine")


@contextlib.contextmanager
def recorded_engines(mod, runs: list, count: bool = True):
    """Every engine that module ``mod`` builds, recorded when it first
    reports (engine_fig8) or closes (engine_overhead): its mode, backend,
    steps and report and, with ``count``, the kernel launches since it
    was built (the counts set to 0 there)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    base = mod.Engine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._recorded = False
            if count:
                torch.cuda.synchronize()
                reset_launch_counts()

        def report(self):
            r = super().report()
            if not self._recorded:
                self._recorded = True
                runs.append({"mode": self.ecfg.mode,
                             "backend": self.ecfg.backend,
                             "steps": self.step_no, "report": r,
                             "launches": launch_counts() if count else None})
            return r

        def close(self):
            self.report()
            super().close()

    mod.Engine = Recorded
    try:
        yield runs
    finally:
        mod.Engine = base


@contextlib.contextmanager
def replaced(mod, name: str, fn):
    """``mod.name`` is ``fn`` inside the block."""
    inner = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield inner
    finally:
        setattr(mod, name, inner)


@contextlib.contextmanager
def suite_overhead_cut(EO):
    """The suite's ``engine_overhead.run`` at ``SUITE_OVERHEAD_STEPS``
    timed steps a run and its gate at ``SUITE_GATE_ITERS`` calls
    (``SUITE_CUT``)."""
    run, gate = EO.run, EO.fused_kernel_gate
    with replaced(EO, "run", lambda **kw: run(
            **dict(kw, steps=SUITE_OVERHEAD_STEPS))), \
            replaced(EO, "fused_kernel_gate", lambda quick, **kw: gate(
                quick, **dict(kw, iters=SUITE_GATE_ITERS))):
        yield


def no_gate(quick, iters=300, **kw) -> dict:
    """engine_overhead's fused-kernel gate left out of a CPU reference
    run (on CPU tensors both of its sides are the plain charge)."""
    return {}


def evaluation_reference(name: str):
    """The port's CPU run an evaluation check on the card is held to:
    ``multitenant`` (``multitenant_isolation.main`` at its defaults),
    ``engine_overhead`` (the smoke's engine runs) and ``suite`` (the
    suite at reduced width: its results, printed text and engine runs)."""
    from repro_torch.evaluation import engine_fig8 as EF8
    from repro_torch.evaluation import engine_overhead as EO
    from repro_torch.evaluation import multitenant_isolation as MT
    from repro_torch.evaluation import run as RUN

    if name == "multitenant":
        return MT.main(["--device", "cpu"])
    fig8, overhead = [], []
    with replaced(EO, "fused_kernel_gate", no_gate), \
            recorded_engines(EO, overhead, count=False), \
            recorded_engines(EF8, fig8, count=False):
        if name == "engine_overhead":
            kw = dict(EVAL_OVERHEAD, quick=False)   # the card holds gates
            return {"out": EO.run(**kw, device="cpu"), "runs": overhead}
        text = io.StringIO()
        with suite_overhead_cut(EO), contextlib.redirect_stdout(text):
            out = RUN.run(device="cpu",
                          dryrun_dir=str(ROOT / "build" / "no_dryrun"))
    return {"out": out, "text": text.getvalue(), "fig8": fig8,
            "overhead": overhead}


def same_json(a, b) -> bool:
    """Equal as JSON text (tuples as lists, NaN as NaN, numpy scalars by
    value)."""
    def text(x):
        return json.dumps(x, sort_keys=True, default=lambda v: v.item()
                          if hasattr(v, "item") else str(v))
    return text(a) == text(b)


def sections(text: str) -> dict:
    """Printed output by ``== header`` line."""
    return {part.split("\n", 1)[0]: part
            for part in ("\n" + text).split("\n== ")[1:]}


def check_engine_runs(what: str, names: tuple, got: list, want: list,
                      layers: int) -> dict:
    """Each card run (``names``, in order) with its report equal to the
    CPU run's, a decode launch a layer a step and a charge launch a step
    in inkernel mode."""
    if len(got) != len(names) or [r["report"] for r in got] != \
            [r["report"] for r in want]:
        raise AssertionError(f"{what}: reports differ from the reduced CPU "
                             f"run:\n{got}\n{want}")
    out = {}
    for name, r in zip(names, got):
        steps, counts = r["steps"], r["launches"]
        expect = {k: 0 for k in counts}
        expect.update(decode_attention=layers * steps,
                      fused_charge_batch=steps if r["mode"] == "inkernel"
                      else 0)
        if counts != expect:
            raise AssertionError(f"{what} {r['mode']}/{r['backend']}: "
                                 f"launches {counts}, expected {expect}")
        out[name] = {"mode": r["mode"], "backend": r["backend"],
                     "steps": steps, "launches": counts}
    return out


def roofline_rows(text: str, records: dict) -> dict:
    """roofline_table's rows against their records: GiB/dev, the three
    terms, the dominant one, the useful ratio and the roofline fraction."""
    from repro_torch.analysis.roofline import fmt_seconds

    rows = {}
    for line in text.splitlines()[1:]:
        f = line.split()
        rows[(f[0], f[1])] = f[2:]
    if len(rows) != len(records):
        raise AssertionError(f"roofline_table rows {list(rows)}, records "
                             f"{list(records)}")
    out = {}
    for name, rec in records.items():
        r, mem = rec["roofline"], rec["memory"]
        want = ["yes" if mem["fits_hbm"] else "NO",
                f"{mem['per_device_bytes'] / 2**30:.1f}",
                fmt_seconds(r["compute_s"]), fmt_seconds(r["memory_s"]),
                fmt_seconds(r["collective_s"]), r["dominant"][:-2],
                f"{r['useful_flop_ratio']:.2f}",
                f"{r['roofline_fraction']:.3f}"]
        got = rows.get((rec["arch"], rec["shape"]))
        if got != want:
            raise AssertionError(f"roofline_table row of {name}: {got}, "
                                 f"its record {want}")
        out[name] = got
    return out


def eval_multitenant(dev, refs: CpuRefs) -> dict:
    """``multitenant_isolation.main([])`` on the card against the CPU run:
    tenant rows, victims' denial rates and fairness shares and gaps
    equal, one charge launch a step in each configuration."""
    from repro_torch.evaluation import multitenant_isolation as MT
    from repro_torch.kernels import launch_counts, reset_launch_counts

    counts = {}

    def counted(kind, *a, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        res = inner(kind, *a, **kw)
        counts[kind] = launch_counts()
        return res

    t = time.perf_counter()
    text = io.StringIO()
    with replaced(MT, "run_config", counted) as inner, \
            contextlib.redirect_stdout(text):
        res = MT.main([])
    seconds = time.perf_counter() - t
    ref = refs.get("evaluation:multitenant")
    steps = MT.parser().parse_args([]).steps
    for kind in ("shared", "sharded"):
        for key in ("tenants", "victim_denial_rate"):
            if res[kind][key] != ref[kind][key]:
                raise AssertionError(f"multitenant {kind} {key}: "
                                     f"{res[kind][key]} on the card, "
                                     f"{ref[kind][key]} on the CPU")
        expect = {k: 0 for k in counts[kind]}
        expect["fused_charge_batch"] = steps
        if counts[kind] != expect:
            raise AssertionError(f"multitenant {kind}: launches "
                                 f"{counts[kind]}, expected {expect}")
    fair = {label: {k: res["fairness"][label][k] for k in ("share",
                                                           "p99_gap")}
            for label in ("weighted", "uniform")}
    if fair != {label: {k: ref["fairness"][label][k]
                        for k in ("share", "p99_gap")}
                for label in fair}:
        raise AssertionError(f"fairness on the card {fair}, on the CPU "
                             f"{ref['fairness']}")
    return {"seconds": seconds, "launches": counts,
            "victim_denial_rate": {k: res[k]["victim_denial_rate"]
                                   for k in ("shared", "sharded")},
            "charge_steps_per_s": {k: res[k]["steps_per_s"]
                                   for k in ("shared", "sharded")},
            "fairness": fair,
            "sched_steps_per_s": {k: res["fairness"][k]["steps_per_s"]
                                  for k in fair},
            "lines": text.getvalue().splitlines()}


def eval_overhead(dev, params, layers: int, refs: CpuRefs) -> dict:
    """CI's smoke, ``engine_overhead --quick --backend async``, at full
    width on the card: its three gates hold (they raise), every engine
    run's report equals the reduced CPU run's."""
    from repro_torch.evaluation import engine_overhead as EO

    runs = []
    t = time.perf_counter()
    text = io.StringIO()
    with recorded_engines(EO, runs), contextlib.redirect_stdout(text):
        res = EO.run(**EVAL_OVERHEAD, device=dev, full=True, params=params)
    seconds = time.perf_counter() - t
    ref = refs.get("evaluation:engine_overhead")
    engines = check_engine_runs("engine_overhead", OVERHEAD_RUNS, runs,
                                ref["runs"], layers)
    if any(r["steps"] != EVAL_WARM + EVAL_OVERHEAD["steps"] for r in runs):
        raise AssertionError(f"engine_overhead steps {runs}")
    return {"seconds": seconds, "args": EVAL_OVERHEAD, "result": res,
            "ratio_core": res["p50_core"] / res["p50_off"],
            "ratio_full": res["p50_full"] / res["p50_off"],
            "ratio_async": res["p50_async"] / res["p50_core"],
            "engines": engines, "lines": text.getvalue().splitlines()}


def eval_suite(dev, params, layers: int, refs: CpuRefs) -> dict:
    """The suite ``evaluation.run`` at full width on the card against its
    reduced CPU run (see the module docstring)."""
    import shutil

    from repro_torch.evaluation import engine_fig8 as EF8
    from repro_torch.evaluation import engine_overhead as EO
    from repro_torch.evaluation import run as RUN
    from repro_torch.evaluation import throttle_precision as TP
    from repro_torch.kernels import launch_counts, reset_launch_counts

    shutil.rmtree(EVAL_DRYRUN, ignore_errors=True)
    EVAL_DRYRUN.mkdir(parents=True)
    records = {}
    for name in DRYRUN_RUNS:
        records[name] = refs.get(f"dryrun:{name}")
        (EVAL_DRYRUN / f"{name}.json").write_text(json.dumps(records[name]))
    throttle = {}

    def counted(*a, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        res = inner(*a, **kw)
        throttle.update(launch_counts())
        return res

    fig8, overhead = [], []
    t = time.perf_counter()
    text = io.StringIO()
    with recorded_engines(EF8, fig8), recorded_engines(EO, overhead), \
            replaced(TP, "run", counted) as inner, suite_overhead_cut(EO), \
            contextlib.redirect_stdout(text):
        out = RUN.run(device=dev, full=True, params=params,
                      dryrun_dir=str(EVAL_DRYRUN))
    seconds = time.perf_counter() - t
    ref = refs.get("evaluation:suite")
    engines = {"engine_fig8": check_engine_runs(
                   "suite engine_fig8", FIG8_RUNS, fig8, ref["fig8"], layers),
               "engine_overhead": check_engine_runs(
                   "suite engine_overhead", OVERHEAD_RUNS[:3], overhead,
                   ref["overhead"], layers)}
    if out["engine_fig8"] != ref["out"]["engine_fig8"]:
        raise AssertionError("suite engine_fig8 differs from the CPU run")
    tp = out["throttle_precision"]
    if (tp["mechanism_ms"], tp["mechanism_err"]) != (2000.0, 0.0):
        raise AssertionError(f"throttle mechanism {tp}")
    expect = {k: 0 for k in throttle}
    expect.update(fused_charge_batch=2, fused_slot_gate=2 * 200 + 1)
    if throttle != expect:
        raise AssertionError(f"throttle launches {throttle}, expected "
                             f"{expect}")
    for name in HOST_SECTIONS:
        if not same_json(out[name], ref["out"][name]):
            raise AssertionError(f"suite {name} differs from the CPU run")
    got, want = sections(text.getvalue()), sections(ref["text"])
    for head in [h for h in want if h.startswith(HOST_HEADERS)]:
        if got.get(head) != want[head]:
            raise AssertionError(f"suite section {head!r} differs from the "
                                 f"CPU run:\n{got.get(head)}\n{want[head]}")
    fair = {k: {f: out["multitenant_isolation"][k][f]
                for f in ("share", "p99_gap")} for k in ("weighted",
                                                         "uniform")}
    if fair != {k: {f: ref["out"]["multitenant_isolation"][k][f]
                    for f in ("share", "p99_gap")} for k in fair}:
        raise AssertionError(f"suite fairness {fair} differs from the CPU")
    rows = roofline_rows(out["roofline_table"], records)
    keep = ("live-engine", "in-step", "fused", "weighted", "throttle",
            "roofline")
    return {"seconds": seconds, "cut": SUITE_CUT, "engines": engines,
            "engine_overhead": out["engine_overhead"],
            "throttle_precision": tp, "throttle_launches": throttle,
            "fairness": fair, "roofline_rows": rows,
            "lines": [line for head, block in got.items()
                      if head.startswith(keep)
                      for line in ("== " + block).splitlines()]}


def evaluation(dev, seed: int, refs: CpuRefs) -> dict:
    """The evaluation twins on the card (``repro_torch.evaluation``),
    each against the port's CPU run of the same call."""
    from repro_torch.evaluation import engine_fig8 as EF8

    t = time.perf_counter()
    cfg, params = EF8.model(dev, full=True)
    model = {"arch": EF8.ARCH, "layers": cfg.n_layers,
             "d_model": cfg.d_model, "dtype": cfg.dtype}
    out = {"model": model, "multitenant": eval_multitenant(dev, refs),
           "engine_overhead": eval_overhead(dev, params, cfg.n_layers,
                                            refs),
           "suite": eval_suite(dev, params, cfg.n_layers, refs)}
    return dict(out, seconds=time.perf_counter() - t)


def _host_gate(snap: dict, dom: list, step: int) -> list:
    """The stock programs' gate from the snapshot: no frozen or
    throttled ancestor within the 4-deep chain."""
    out = []
    for d in dom:
        ok, i = d >= 0, d
        for _ in range(4):
            if i < 0 or d < 0:
                break
            ok &= not snap["frozen"][i] and snap["throttle_until"][i] <= step
            i = int(snap["parent"][i])
        out.append(bool(ok))
    return out


# -------------------------------------------------------------------- main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="lint,kernels,engine_parity,engine_full,conformance,"
                            "replay,serve_full,families_full,control_full,"
                            "train_parity,train_full,prefill_parity,"
                            "prefill_full,frontends_full,mla_full,examples,"
                            "evaluation,dryrun",
                    help="comma-separated phases to run, of lint, "
                         "kernels, "
                         "engine_parity, engine_full, conformance, replay, "
                         "serve_full, families_full, control_full, "
                         "train_parity, train_full, prefill_parity, "
                         "prefill_full, frontends_full, mla_full, "
                         "examples, evaluation, "
                         "dryrun (after the phases it compares), and "
                         "profile, "
                         "train_profile and prefill_profile (not in the "
                         "default run); the result line is printed only "
                         "when lint, kernels, engine_full, conformance, "
                         "serve_full, families_full, control_full, "
                         "train_full, prefill_full, frontends_full, "
                         "mla_full, examples, evaluation and dryrun "
                         "ran")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = CpuRefs(phases, args.seed)
    try:
        run_phases(phases, args.seed, refs)
    finally:
        refs.close()


def lint_phase() -> dict:
    """The port's tracelint over the tree as shipped, with the checked-in
    baseline, paths relative to the working directory (the root of a
    checkout) as the baseline's fingerprints are."""
    from repro_torch.analysis.lint import (apply_baseline, lint_paths,
                                           load_baseline)
    from repro_torch.analysis.lint.cli import rule_table
    from repro_torch.analysis.lint.core import iter_py_files

    t = time.perf_counter()
    paths = [os.path.relpath(SRC / "repro_torch"),
             os.path.relpath(ROOT / "chip_smoke.py")]
    found, grandfathered = apply_baseline(
        lint_paths(paths), load_baseline(str(ROOT / "tracelint-baseline.json")))
    seconds = time.perf_counter() - t
    if found:
        raise AssertionError("tracelint findings:\n"
                             + "\n".join(f.format() for f in found))
    return {"rules": rule_table(), "paths": paths,
            "files": len(iter_py_files(paths)), "findings": len(found),
            "grandfathered": grandfathered, "seconds": seconds}


def run_phases(phases: list, seed: int, refs: CpuRefs) -> None:
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[{name}] {line.strip()}", file=sys.stderr)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": card, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "build_s": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})

    lint = None
    if "lint" in phases:
        lint = lint_phase()
        emit({"phase": "lint", **lint})
    rows = None
    if "kernels" in phases:
        emit({"phase": "sass", **kernel_sass(libs)})
        emit({"phase": "ptxas", "flash_backward": flash_ptxas(libs)})
        secs = {}

        def timed(check):
            t = time.perf_counter()
            res = check(dev, seed)
            secs[check.__name__] = time.perf_counter() - t
            return res

        enf = timed(check_enforcement)
        shards = timed(check_shard_enforcement)
        tim = timed(time_enforcement)
        dec = timed(check_decode)
        pag = timed(check_paged)
        fla = timed(check_flash)
        front = timed(check_flash_frontends)
        mla = timed(check_flash_mla)
        ssd = timed(check_ssd)
        emit({"phase": "kernels", "card": card, "seconds": secs,
              "enforcement": enf,
              "enforcement_shards": shards,
              "enforcement_times": tim, "decode_attention": dec,
              "paged_decode_attention": pag, "flash_attention": fla,
              "flash_attention_frontends": front, "flash_attention_mla": mla,
              "ssd_scan": ssd})
        rows = {
            "fused_charge_batch": dict(
                source="src/repro_torch/csrc/enforcement.cu",
                replaces="src/repro/kernels/enforcement.py:149",
                max_abs_err=enf["charge_max_abs_err"],
                timing=tim["charge"] + (None,),
                extra=dict(tim["charge_extra"], shard_shapes={
                    k: v["charge"] for k, v in shards.items()})),
            "fused_slot_gate": dict(
                source="src/repro_torch/csrc/enforcement.cu",
                replaces="src/repro/kernels/enforcement.py:193",
                max_abs_err=enf["gate_max_abs_err"],
                timing=tim["gate"] + (None,),
                extra=dict(tim["gate_extra"], shard_shapes={
                    k: v["gate"] for k, v in shards.items()})),
            "decode_attention": dict(
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:87",
                **decode_row(dec)),
            "paged_decode_attention": dict(
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:166",
                **decode_row(pag)),
        }
        cases = dict(fla, **{k: v for k, v in front.items()
                             if k.startswith(("d160", "hubert"))},
                     **{k: v for k, v in mla.items() if k != "times"})
        hubert = front["times"]["hubert_d80_full"]
        for name, parts in (("flash_fwd", ("out", "lse")),
                            ("flash_bwd", ("dq", "dk", "dv"))):
            errs = [e[k] for case, e in cases.items()
                    if case.startswith(("train", "ragged", "cross",
                                        "head", "group", "d160", "hubert",
                                        "mla", "example"))
                    for k in parts if k in e]
            pas = name.split("_")[1]
            rows[name] = dict(
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:92",
                max_abs_err=max(e["max_abs"] for e in errs),
                norm_rel_err=max(e["norm_rel"] for e in errs),
                timing=fla["timing"][name],
                extra={"group_shapes": {
                    case: {k: v for k, v in t.items() if k.startswith(pas)}
                    for case, t in fla["family_times"].items()},
                    "hubert_d80_full": {k: v for k, v in hubert.items()
                                        if k.startswith(pas)},
                    "example_shapes": {
                        case: dict({k: v for k, v in t.items()
                                    if k.startswith(pas)},
                                   library_ms=t["library"][f"{pas}_ms"],
                                   library_backend=t["library"]["backend"])
                        for case, t in fla["times_by_example"].items()}})
        rows["flash_fwd"]["extra"]["pixtral_d160"] = \
            front["times"]["pixtral_d160"]
        for name in ("flash_fwd", "flash_bwd"):
            pas = name.split("_")[1]
            for shape in ("mla", "d160_bwd"):
                t = mla["times"][shape]
                if shape == "d160_bwd" and pas == "fwd":
                    continue
                rows[name]["extra"][f"{shape}_full"] = dict(
                    {k: v for k, v in t.items() if k.startswith(pas)},
                    library_ms=t["library"][f"{pas}_ms"],
                    library_backend=t["library"]["backend"])
        ssd_errs = [e[k] for case, e in ssd.items()
                    if case not in ("timing", "kernel_ms")
                    for k in ("y", "h")]
        rows["ssd_scan"] = dict(
            source="src/repro_torch/csrc/mamba_scan.cu",
            replaces="src/repro/kernels/mamba_scan.py:88",
            max_abs_err=max(e["max_abs"] for e in ssd_errs),
            norm_rel_err=max(e["norm_rel"] for e in ssd_errs),
            timing=ssd["timing"], kernel_ms=ssd["kernel_ms"])
    if "engine_parity" in phases:
        emit({"phase": "engine_parity", "card": card,
              **engine_parity(dev, seed, refs)})
    full = None
    if "engine_full" in phases:
        full = engine_full(dev, seed, refs)
        emit({"phase": "engine_full", "card": card, **full})
    conf = None
    if "conformance" in phases:
        conf = conformance(dev, seed)
        emit({"phase": "conformance", "card": card, **conf})
    if "replay" in phases:
        emit({"phase": "replay", **replay_drivers(seed)})
    served = None
    if "serve_full" in phases:
        served = serve_full(dev, seed, refs)
        emit({"phase": "serve_full", "card": card, **served})
    fams = None
    if "families_full" in phases:
        fams = families_full(dev, seed, refs, served)
        emit({"phase": "families_full", "card": card, **fams})
    ctrl = None
    if "control_full" in phases:
        ctrl = control_full(dev, seed, refs,
                            served["report"] if served else None)
        emit({"phase": "control_full", "card": card, **ctrl})
    if "train_parity" in phases:
        emit({"phase": "train_parity", "card": card,
              **train_parity(dev, seed)})
    train = None
    if "train_full" in phases:
        train = train_full(dev, seed)
        emit({"phase": "train_full", "card": card, **train})
    if "prefill_parity" in phases:
        emit({"phase": "prefill_parity", "card": card,
              **prefill_parity(dev, seed)})
    prefill = None
    if "prefill_full" in phases:
        prefill = prefill_full(dev, seed)
        emit({"phase": "prefill_full", "card": card, **prefill})
    fronts = None
    if "frontends_full" in phases:
        fronts = frontends_full(dev, seed)
        emit({"phase": "frontends_full", "card": card, **fronts})
    mla_run = None
    if "mla_full" in phases:
        mla_run = mla_full(dev, seed)
        emit({"phase": "mla_full", "card": card, **mla_run})
    ex = None
    if "examples" in phases:
        ex = examples(dev, seed, refs)
        emit({"phase": "examples", "card": card, **ex})
    ev = None
    if "evaluation" in phases:
        ev = evaluation(dev, seed, refs)
        emit({"phase": "evaluation", "card": card, **ev})
    dry = None
    if "dryrun" in phases:
        by_phase = {"train_full": train, "prefill_full": prefill,
                    "frontends_full": fronts, "mla_full": mla_run}
        measured = {}
        for name, (phase, key, *_) in DRYRUN_RUNS.items():
            res = by_phase[phase]
            if res is not None:
                measured[name] = res if key is None else res[key]
        dry = dryrun_phase(measured, refs)
        emit({"phase": "dryrun", "card": card, "tolerance": DRYRUN_TOL,
              "runs": dry})
    if "profile" in phases:
        emit({"phase": "profile", "card": card,
              **profile_step(dev, seed)})
    if "train_profile" in phases:
        emit({"phase": "train_profile", "card": card,
              **train_profile(dev, seed)})
    if "prefill_profile" in phases:
        emit({"phase": "prefill_profile", "card": card,
              **prefill_profile(dev, seed)})
    if lint is None or rows is None or full is None or train is None \
            or prefill is None \
            or conf is None or served is None or ctrl is None or fams is None \
            or fronts is None or mla_run is None or ex is None or dry is None \
            or ev is None:
        return
    launches = dict(full["launches"], **train["launches"],
                    ssd_scan=prefill["launches_per_prefill"]["ssd_scan"])
    # each path's own launches, its counts set to 0 just before it
    by_path = {"engine_full": full["launches"],
               "serve_full": served["launches"],
               **{f"conformance_n{n}": c["launches"]
                  for n, c in conf["sizes"].items()},
               **{f"conformance_{k}": c["launches"]
                  for k, c in conf["kinds"].items()
                  if not k.startswith("device_")},
               **{f"conformance_faulty_{k}": c["launches"]
                  for k, c in conf["faulty"].items()},
               **{f"control_full_{k}": c["launches"]
                  for k, c in ctrl.items() if isinstance(c, dict)},
               **{f"families_full_{k}": c["launches"]
                  for k, c in fams["runs"].items()},
               **{f"frontends_full_{k}": fronts[k]["launches"]
                  for k in ("hubert_train_full", "pixtral_forward_full",
                            "pixtral_train_full")},
               **{f"mla_full_{k}": mla_run[k]["launches"]
                  for k in ("mla_parity", "deepseek_forward_full")},
               "examples_quickstart": ex["quickstart"]["launches"],
               **{f"examples_serve_agents_{k}": m["launches"]
                  for k, m in ex["serve_agents"]["modes"].items()},
               "examples_train_100m": ex["train_100m"]["launches"],
               **{f"evaluation_multitenant_{k}": c
                  for k, c in ev["multitenant"]["launches"].items()},
               **{f"evaluation_engine_overhead_{k}": r["launches"]
                  for k, r in ev["engine_overhead"]["engines"].items()},
               **{f"evaluation_suite_{part}_{k}": r["launches"]
                  for part, runs in ev["suite"]["engines"].items()
                  for k, r in runs.items()},
               "evaluation_suite_throttle_precision":
                   ev["suite"]["throttle_launches"]}
    # the forward's errors include those at the prefill shape
    fwd = rows["flash_fwd"]
    for e in prefill["flash_fwd_prefill_errs"].values():
        fwd["max_abs_err"] = max(fwd["max_abs_err"], e["max_abs"])
        fwd["norm_rel_err"] = max(fwd["norm_rel_err"], e["norm_rel"])
    table = []
    for name, r in rows.items():
        ms, plain, (bnd, by), lib = r["timing"]
        table.append({"name": name, "route": "cuda", "source": r["source"],
                      "replaces": r["replaces"],
                      "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": ms,
                      "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
                      "library_ms": lib,
                      **({"max_norm_rel_err": r["norm_rel_err"]}
                         if "norm_rel_err" in r else {}),
                      **({"kernel_ms": r["kernel_ms"]}
                         if "kernel_ms" in r else {}),
                      **({"launches_by_path": {
                          p: c[name] for p, c in by_path.items()}}
                         if name in full["launches"] and any(
                             c[name] for c in by_path.values()) else {}),
                      **r.get("extra", {})})
    emit({"kernels": table})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
