"""Plain reference of the in-step charge, in numpy.

The memcg charge that AgentCgroup runs inside a serving step, written
from its stated semantics for the stock graduated-throttle program (the
paper's section 5): the slots are decided one after another; a slot is
denied when an ancestor of its domain (itself included, at most
``DEPTH`` levels) is frozen, throttled past this step, or would pass its
hard ``max``; a granted slot's pages go to every ancestor's usage, every
domain's peak takes the usage, and a charge that leaves an ancestor
over its soft ``high`` throttles the charged domain for

    ceil(min(max_delay, base_delay * (1 + gain * overage)) / step_ms)

steps (times the HIGH-priority discount; none where every over-high
ancestor stays within its ``low``), the overage being the largest
``(usage - high) / high`` along the chain.  Each denial or throttle adds
one saturating memory-stall event to the charged domain.  The delay is
computed in float32, the multiply-add ``gain * overage + 1`` with one
rounding, as the decision of record states it.
"""
from __future__ import annotations

import numpy as np

DEPTH = 4
UNLIMITED = (1 << 31) - 1
HIGH = 2
INT32_MAX = (1 << 31) - 1
F32 = np.float32


def _chain(parent, d: int) -> list:
    out, i = [], d
    for _ in range(DEPTH):
        if i < 0:
            break
        out.append(i)
        i = int(parent[i])
    return out


def delay_ms(row, over_frac, priority: int, protected: bool) -> np.float32:
    """The graduated-throttle delay of one charge, float32."""
    base, mx, gain, disc = (F32(v) for v in row[:4])
    # gain * over_frac + 1 with a single rounding (f64 holds the product)
    fma = F32(np.float64(gain) * np.float64(over_frac) + 1.0)
    d = min(mx, base * fma)
    if priority == HIGH:
        d = F32(d * disc)
    return F32(0.0) if protected else F32(d)


def charge(table: dict, dom, amt, step: int, step_ms: float) -> dict:
    """Decide one step's charges from the table before it.

    ``table`` holds numpy columns ``parent, high, max, low, frozen,
    priority, usage, peak, throttle_until, mem_stall`` (n,) and ``prog``
    (n, P); ``dom`` and ``amt`` are the slots' domains (-1: no request)
    and pages.  Returns the new ``usage, peak, throttle_until, prog,
    mem_stall`` and the slots' ``granted`` and ``stalled``."""
    parent = table["parent"]
    usage = table["usage"].astype(np.int64)
    peak = table["peak"].astype(np.int64)
    tu = table["throttle_until"].astype(np.int64)
    stall_ct = table["mem_stall"].astype(np.int64)
    prog = table["prog"].copy()
    inv_step = F32(1.0) / F32(step_ms)
    m = len(dom)
    granted = np.zeros(m, bool)
    stalled = np.zeros(m, bool)
    for i in range(m):
        d, a = int(dom[i]), int(amt[i])
        if d < 0:
            np.maximum(peak, usage, out=peak)
            continue
        ch = _chain(parent, d)
        frozen = any(bool(table["frozen"][c]) for c in ch)
        throttled = any(tu[c] > step for c in ch)
        over_max = any(usage[c] + a > table["max"][c] for c in ch)
        grant = not (frozen or throttled or over_max)
        add = a if grant else 0
        over_frac = F32(0.0)
        protected = True
        for c in ch:
            new = usage[c] + add
            high = int(table["high"][c])
            over = new - high if high < UNLIMITED else 0
            if over > 0:
                frac = F32(over) / F32(max(high, 1))
                over_frac = max(over_frac, frac)
                protected = protected and bool(new <= table["low"][c])
        dly = delay_ms(prog[d], over_frac, int(table["priority"][d]),
                       protected)
        throttle = grant and over_frac > 0
        if grant:
            for c in ch:
                usage[c] += a
        np.maximum(peak, usage, out=peak)
        if throttle:
            steps = int(np.ceil(F32(dly * inv_step)))
            tu[d] = max(tu[d], step + steps)
        if (not grant) or throttle:
            stall_ct[d] = min(INT32_MAX, stall_ct[d] + 1)
        granted[i], stalled[i] = grant, not grant
    return {"usage": usage, "peak": peak, "throttle_until": tu,
            "prog": prog, "mem_stall": stall_ct, "granted": granted,
            "stalled": stalled}
