"""Hierarchical weighted step scheduler — the sched_ext/scx_flatcg half.

Port of ``repro/core/sched.py`` in plain torch (the reference has no
Pallas kernel for it).  A domain's ``flat_weight`` is the product of
(own weight / sibling weight sum) along its path, recomputed host-side
at lifecycle rate; per step:

  1. every slot asks its program for a scheduling weight
     (``on_schedule``; ``<= 0`` means "outside the weighted scheduler");
  2. runnable weighted slots are ranked by their domain's ``vruntime``,
     ties broken by slot index;
  3. grants are taken greedily until the step ``budget`` is spent;
  4. ``cpu.max`` acts as a hard per-window throttle.

The ``vruntime`` account is updated slot by slot, never by a scatter
with atomics, so the f32 sums come out in the reference's order on
every device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import domains as D
from repro_torch.core.controller import UNLIMITED, _ancestor_chain, _chain_view
from repro_torch.core.pressure import saturating_count, sched_stall_events
from repro_torch.core.progs import (GraduatedThrottleProgram, SchedRequest,
                                    SchedView, as_programs, gate_decision,
                                    schedule_weight, xla_exp2)

DEFAULT_WEIGHT = D.DEFAULT_WEIGHT
MIN_WEIGHT, MAX_WEIGHT = 1, 10000


def check_weight(value: int) -> int:
    v = int(value)
    if not (MIN_WEIGHT <= v <= MAX_WEIGHT):
        raise ValueError(f"cpu.weight must be in "
                         f"[{MIN_WEIGHT}, {MAX_WEIGHT}], got {value}")
    return v


def flat_weights_by_path(weights: dict) -> dict:
    """Flatten the hierarchy the way scx_flatcg does: ``flat(d) =
    flat(parent) * weight(d) / sum(sibling weights)``, root 1.0.  Pure
    host math over the logical tree; the division result is cast to f32
    exactly once, as in the reference."""
    kids: dict = {}
    for p in weights:
        if p != "/":
            kids.setdefault(p.rsplit("/", 1)[0] or "/", []).append(p)
    flat = {"/": np.float32(1.0)}
    stack = ["/"]
    while stack:
        q = stack.pop()
        ch = sorted(kids.get(q, []))
        tot = sum(weights[c] for c in ch)
        for c in ch:
            flat[c] = np.float32(float(flat[q]) * weights[c] / tot)
            stack.append(c)
    return flat


def schedule_decision(prog, state: dict, dom, cost, step, budget):
    """One scheduling round.  ``dom[i]``/``cost[i]`` describe slot ``i``
    (-1 = empty slot); ``budget`` is the total step cost grantable to
    weighted slots.  Returns ``(new_state, advance)``."""
    progs = as_programs(prog)
    dev = state["usage"].device
    dom = dom.to(torch.int32)
    cost = cost.to(torch.int32)
    step = torch.as_tensor(step, dtype=torch.int32, device=dev)
    window = torch.div(step, progs[0].sched_window, rounding_mode="floor")
    eff_used = torch.where(state["cpu_stamp"] == window, state["cpu_used"],
                           torch.zeros_like(state["cpu_used"]))

    view = _chain_view(state, state["usage"], state["throttle_until"],
                       state["prog"], dom)
    gate = (dom >= 0) & gate_decision(progs, view, step)
    chain = _ancestor_chain(state["parent"], torch.clamp(dom, min=0))
    cvalid = (chain >= 0) & (dom >= 0)[:, None]
    cidx = torch.clamp(chain, min=0).long()
    capped = cvalid & (state["cpu_max"][cidx] < UNLIMITED)
    quota_ok = ~(capped & (eff_used[cidx] >= state["cpu_max"][cidx])).any(-1)
    di = torch.clamp(dom, min=0).long()
    sview = SchedView(
        valid=cvalid,
        frozen=cvalid & state["frozen"][cidx],
        throttle_until=torch.where(cvalid, state["throttle_until"][cidx],
                                   torch.zeros_like(chain)),
        weight=state["weight"][di],
        flat_weight=state["flat_weight"][di],
        vruntime=state["vruntime"][di],
        priority=state["priority"][di],
        params=state["prog"][di],
        prog_id=state["prog_id"][di],
    )
    w = schedule_weight(progs, sview, SchedRequest(dom, cost, step)).float()
    runnable = gate & quota_ok
    weighted = runnable & (w > 0)
    bypass = runnable & (w <= 0)

    inf = torch.full_like(w, float("inf"))
    key = torch.where(weighted, state["vruntime"][di], inf)
    # a stable sort by key keeps equal keys (inf included) in slot
    # order: the reference's lexsort((arange, key))
    order = torch.sort(key, stable=True).indices
    cum = torch.cumsum(torch.where(weighted, cost,
                                   torch.zeros_like(cost))[order], 0)
    granted = torch.zeros_like(weighted)
    granted[order] = weighted[order] & (cum <= budget)
    advance = granted | bypass

    # fairness account: granted weighted slots pay cost / weight, one
    # slot after another (duplicate domains sum in slot order)
    pay = torch.where(granted, cost.float() / torch.clamp(w, min=1e-9),
                      torch.zeros_like(w))
    pay = torch.where(dom >= 0, pay, torch.zeros_like(pay))
    vr = state["vruntime"].clone()
    for i in range(dom.shape[0]):
        vr[di[i]] = vr[di[i]] + pay[i]
    # lag clamp: nobody trails the pack by more than sched_lag
    vmin = torch.cat([torch.where(weighted, vr[di], inf),
                      w.new_full((1,), float("inf"))]).amin()
    floor = torch.where(weighted.any(),
                        vmin - torch.tensor(progs[0].sched_lag,
                                            dtype=torch.float32, device=dev),
                        torch.tensor(float("-inf"), device=dev))
    vr = torch.where(state["active"], torch.maximum(vr, floor), vr)

    # cpu.max window accounting: advancing slots charge their chain
    avalid = cvalid & advance[:, None]
    add = torch.where(avalid, cost[:, None], torch.zeros_like(chain))
    used = eff_used.index_add(0, cidx.reshape(-1), add.reshape(-1))
    # PSI accounting: each valid slot that may not advance is one
    # CPU-stall event on its domain, saturating at INT32_MAX
    stall_inc = torch.zeros_like(state["cpu_stall"]).index_add(
        0, di, torch.where(dom >= 0, sched_stall_events(dom, advance),
                           torch.zeros_like(dom)))
    cpu_stall = saturating_count(state["cpu_stall"], stall_inc)
    new_state = dict(state, vruntime=vr, cpu_used=used,
                     cpu_stamp=window.expand_as(state["cpu_stamp"]).clone(),
                     cpu_stall=cpu_stall)
    return new_state, advance


class WeightedFairProgram(GraduatedThrottleProgram):
    """The stock weighted-fair scheduler program: weighted slots get
    their domain's flattened hierarchical weight scaled by a live
    ``sched_boost`` (power of two, 0 = neutral); ``sched_on`` gates the
    scheduler per domain.  It charges as the graduated program."""

    param_names = GraduatedThrottleProgram.param_names + (
        "sched_boost", "sched_on")

    def default_row(self) -> np.ndarray:
        return np.concatenate([super().default_row(),
                               np.asarray([0.0, 1.0], np.float32)])

    def on_schedule(self, view, req):
        w = view.flat_weight * xla_exp2(view.params[..., 4])
        return torch.where(view.params[..., 5] > 0, w, torch.zeros_like(w))
