"""Pluggable in-step policy programs — the memcg_bpf_ops analogue.

Port of ``repro/core/progs.py``.  A ``PolicyProgram`` is a small object
of pure hooks on torch tensors

    on_charge(view, req)   -> Verdict          (the try_charge verdict)
    on_over_high(view, req, over_frac, protected) -> delay_ms
    on_gate(view, step)    -> may-advance bool (the slot gate)
    on_schedule(view, req) -> scheduling weight

closed over a per-domain parameter table ``(n_domains, P)`` f32 that
rides in the control state (key ``"prog"``), so a retune is a state
write.  Views carry any batch shape ``S`` (``()`` for one request in
the sequential charge loop, ``(m,)`` for the vectorized gate and
scheduler) followed by the ancestor-chain axis of length ``DEPTH``.

The plain torch hooks are the decision of record on every device.  On
the card the stock programs also have a CUDA form, compiled into
``csrc/enforcement.cu``; ``kernels/enforcement.py`` maps each stock
program type to its kind code there.  A program with no CUDA form runs
on CPU tensors only.

XLA on the CPU contracts ``a + b * c`` into one fused multiply-add, and
the JAX package is the reference, so the two places where the stock
curves multiply and add go through ``fma`` below: one rounding, as the
reference and the CUDA kernel (``__fmaf_rn``) compute it.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import domains as D
from repro_torch.core.domains import (BASE_DELAY_MS, HIGH_PRIORITY_DISCOUNT,
                                      MAX_DELAY_MS, OVERAGE_GAIN)


def path_in_scope(scope: str, path: str) -> bool:
    """Is ``path`` inside the subtree rooted at ``scope``?"""
    return (scope == "/" or path == scope
            or path.startswith(scope.rstrip("/") + "/"))


def fma(a, b, c):
    """``a * b + c`` in f32 with a single rounding (the product of two
    f32 values is exact in f64, so only the final sum rounds — to f64
    and then f32, which agrees with a true FMA except on ties far below
    anything the stock curves produce)."""
    return (a.double() * b.double() + c.double()).float()


_F32_TINY = float(np.finfo(np.float32).tiny)


def xla_exp2(x):
    """``2 ** x`` in f32, bit for bit as XLA on the CPU computes
    ``jnp.exp2``: ``exp(x * f32(ln 2))`` through the Cephes polynomial
    with fused multiply-adds, the input clamped to [-87.8, 88.8], the
    exponent to [-127, 127], and results below the smallest normal f32
    flushed to zero.  ``torch.exp2`` differs from it in the last bit on
    about a quarter of non-integer arguments."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    r = torch.clamp(x.float() * f32(0.693147182), -87.8, 88.8)
    n = torch.floor(fma(r, f32(1.44269504088896341), f32(0.5)))
    n = torch.clamp(n, -127.0, 127.0)
    t = fma(n, f32(-0.693359375), r)
    t = fma(n, f32(2.12194440e-4), t)
    y = torch.full_like(t, 1.9875691500e-4)
    for c in (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
              1.6666665459e-1, 5.0000001201e-1):
        y = fma(y, t, f32(c))
    y = fma(y, t * t, t) + 1
    # 2 ** n from its exponent bits; a NaN input stays NaN through y
    pow2 = ((torch.nan_to_num(n).to(torch.int32) + 127) << 23).view(
        torch.float32)
    out = y * pow2
    return torch.where(out.abs() < _F32_TINY, torch.zeros_like(out), out)


class Request(NamedTuple):
    """One charge attempt, as seen by a program hook."""
    dom: torch.Tensor     # charged domain handle (i32)
    amt: torch.Tensor     # pages requested (i32)
    step: torch.Tensor    # throttle clock: i32 steps on the device table
    #                       and the step clock, f32 ms on the host tree's
    #                       facade clock (``step=None``)


class ChainView(NamedTuple):
    """The charged domain's ancestor chain (self-first), padded/masked so
    invalid entries are neutral (usage 0, limits UNLIMITED, not frozen).
    ``params`` is the charged domain's program row; ``prog_id`` selects
    its decision code from the attached program registry."""
    valid: torch.Tensor            # (..., depth) bool
    usage: torch.Tensor            # (..., depth) i32 — pre-charge
    high: torch.Tensor             # (..., depth) i32
    max: torch.Tensor              # (..., depth) i32
    low: torch.Tensor              # (..., depth) i32
    frozen: torch.Tensor           # (..., depth) bool
    throttle_until: torch.Tensor   # (..., depth) i32 (device table) or
    #                                f32 (host tree), same clock as req.step
    priority: torch.Tensor         # (...) i32 — the charged domain's
    params: torch.Tensor           # (..., P) f32 — the charged domain's row
    prog_id: torch.Tensor          # (...) i32 — registry slot of the domain


class Verdict(NamedTuple):
    """What ``on_charge`` decides (see the reference for the fields)."""
    grant: torch.Tensor            # (...) bool
    stall: torch.Tensor            # (...) bool
    delay_ms: torch.Tensor         # (...) f32 — program-imposed extra delay
    params: torch.Tensor           # (..., P) f32


class SchedRequest(NamedTuple):
    """One slot asking for a step grant, as seen by ``on_schedule``."""
    dom: torch.Tensor
    cost: torch.Tensor
    step: torch.Tensor


class SchedView(NamedTuple):
    """The scheduled domain's masked chain plus its CPU account."""
    valid: torch.Tensor            # (..., depth) bool
    frozen: torch.Tensor           # (..., depth) bool
    throttle_until: torch.Tensor   # (..., depth) i32
    weight: torch.Tensor           # (...) i32
    flat_weight: torch.Tensor      # (...) f32
    vruntime: torch.Tensor         # (...) f32
    priority: torch.Tensor         # (...) i32
    params: torch.Tensor           # (..., P) f32
    prog_id: torch.Tensor          # (...) i32


class PolicyProgram:
    """Base program: the bare memcg contract, no throttling.  Hooks stay
    pure tensor code with no Python control flow on tensor values."""

    param_names: tuple = ()
    step_ms: float = 10.0        # delay quantum
    sched_window: int = 100      # cpu.max accounting window, steps
    sched_lag: float = 8.0       # max vruntime lag a waking domain keeps

    @property
    def n_params(self) -> int:
        return max(1, len(self.param_names))    # keep (n, P) well-formed

    def default_row(self) -> np.ndarray:
        """Row for domains inside the attach scope."""
        return np.zeros((self.n_params,), np.float32)

    def neutral_row(self) -> np.ndarray:
        """Row for domains outside the attach scope."""
        return np.zeros((self.n_params,), np.float32)

    def col(self, name: str) -> int:
        try:
            return self.param_names.index(name)
        except ValueError:
            raise KeyError(
                f"{type(self).__name__} has no param {name!r}; "
                f"knobs: {self.param_names}") from None

    # ------------------------------------------------------------- hooks

    def on_charge(self, view: ChainView, req: Request) -> Verdict:
        """The memcg try_charge contract: deny on a frozen ancestor, an
        active throttle window, or a hierarchical hard-``max`` breach;
        all denials are retryable stalls."""
        frozen = (view.valid & view.frozen).any(-1)
        throttled = (view.valid
                     & (view.throttle_until > req.step[..., None])).any(-1)
        over_max = (view.valid
                    & (view.usage + req.amt[..., None] > view.max)).any(-1)
        deny = frozen | throttled | over_max
        return Verdict(~deny, deny,
                       torch.zeros(deny.shape, dtype=torch.float32,
                                   device=deny.device),
                       view.params)

    def on_over_high(self, view: ChainView, req: Request, over_frac,
                     protected) -> torch.Tensor:
        """Delay (ms, f32) after a granted charge breached ``high``.
        Default: no throttling."""
        return torch.zeros_like(over_frac)

    def on_gate(self, view: ChainView, step) -> torch.Tensor:
        """May a slot in this domain advance this step?  Default: no
        frozen or throttled ancestor."""
        frozen = (view.valid & view.frozen).any(-1)
        throttled = (view.valid
                     & (view.throttle_until > step[..., None])).any(-1)
        return ~frozen & ~throttled

    def on_schedule(self, view: SchedView, req: SchedRequest) -> torch.Tensor:
        """Scheduling weight (f32) for one runnable slot; ``<= 0`` means
        outside the weighted scheduler.  The base program IS the trivial
        program."""
        return torch.zeros_like(view.flat_weight)

    def delay_ms(self, params, over_frac, priority=None, protected=False):
        """Scalar delay math on one param row (host daemons too)."""
        return torch.zeros_like(torch.as_tensor(over_frac,
                                                dtype=torch.float32))


def _decision_one(prog: PolicyProgram, view: ChainView, req: Request):
    """The complete per-request decision for ONE program: contract +
    program verdict, then post-charge soft-limit math routed through
    ``on_over_high``."""
    v = prog.on_charge(view, req)
    add = torch.where(v.grant, req.amt, torch.zeros_like(req.amt))
    new_usage = torch.where(view.valid, view.usage + add[..., None],
                            torch.zeros_like(view.usage))
    over = torch.where(view.valid & (view.high < D.UNLIMITED),
                       new_usage - view.high, torch.zeros_like(view.usage))
    protected = torch.where(view.valid, new_usage <= view.low,
                            torch.ones_like(view.valid))
    # i32 / i32 true division is f32 in the reference, never f64
    frac = over.float() / torch.clamp(view.high, min=1).float()
    over_frac = torch.where(over > 0, frac,
                            torch.zeros_like(frac)).amax(-1)
    post = view._replace(usage=new_usage)
    dly = prog.on_over_high(post, req, over_frac,
                            (protected | (over <= 0)).all(-1))
    dly = torch.maximum(dly.float(), v.delay_ms)
    throttle = v.grant & ((over_frac > 0) | (v.delay_ms > 0))
    return v, dly, throttle


def _single_prog(progs: tuple):
    return progs[0] if len(progs) == 1 else None


def _registry_slot(view, n_progs: int):
    """Each domain's registry slot, out-of-range ids clamped to the
    primary slot 0's side (as ``jnp.clip`` does in the reference)."""
    return torch.clamp(view.prog_id.long(), 0, n_progs - 1)


def _select(idx, branches):
    """Per element of the batch, the branch ``idx`` picks: each branch
    is computed, then one is gathered — the registry replacement for
    ``lax.switch``."""
    stacked = torch.stack(branches)                  # (R, *S, ...)
    extra = stacked.dim() - 1 - idx.dim()
    index = idx.reshape((1,) + tuple(idx.shape) + (1,) * extra)
    return stacked.gather(0, index.expand((1,) + tuple(stacked.shape[1:])))[0]


def charge_decision(prog, view: ChainView, req: Request):
    """The complete per-request decision.  ``prog`` is one program or a
    registry tuple; with a registry, ``view.prog_id`` picks the branch.
    Returns ``(verdict, delay_ms, throttle)``."""
    progs = as_programs(prog)
    single = _single_prog(progs)
    if single is not None:
        return _decision_one(single, view, req)
    idx = _registry_slot(view, len(progs))
    outs = [_decision_one(p, view, req) for p in progs]
    verdict = Verdict(*(_select(idx, [o[0][k] for o in outs])
                        for k in range(4)))
    return (verdict, _select(idx, [o[1] for o in outs]),
            _select(idx, [o[2] for o in outs]))


def gate_decision(prog, view: ChainView, step):
    """``on_gate`` with registry dispatch."""
    progs = as_programs(prog)
    single = _single_prog(progs)
    if single is not None:
        return single.on_gate(view, step)
    idx = _registry_slot(view, len(progs))
    return _select(idx, [p.on_gate(view, step) for p in progs])


def schedule_weight(prog, view: SchedView, req: SchedRequest):
    """``on_schedule`` with registry dispatch: the slot's effective
    scheduling weight under its domain's own program."""
    progs = as_programs(prog)
    single = _single_prog(progs)
    if single is not None:
        return single.on_schedule(view, req)
    idx = _registry_slot(view, len(progs))
    return _select(idx, [p.on_schedule(view, req).float() for p in progs])


def as_program(prog_or_cfg) -> PolicyProgram:
    """A program passes through, a ``ControllerConfig`` (or None)
    becomes the stock graduated-throttle program; registry tuples
    normalize to their primary (slot 0) program."""
    if isinstance(prog_or_cfg, (tuple, list)):
        return as_programs(prog_or_cfg)[0]
    if prog_or_cfg is None:
        return GraduatedThrottleProgram()
    if isinstance(prog_or_cfg, PolicyProgram):
        return prog_or_cfg
    return GraduatedThrottleProgram.from_config(prog_or_cfg)


def as_programs(prog_or_cfg) -> tuple:
    """Normalize to a program registry: an ordered tuple, entry 0 the
    primary (root default)."""
    if isinstance(prog_or_cfg, (tuple, list)):
        progs = tuple(as_program(p) for p in prog_or_cfg)
        return progs if progs else (GraduatedThrottleProgram(),)
    return (as_program(prog_or_cfg),)


def check_registry(progs: tuple) -> tuple:
    """Every program must agree on ``step_ms``/``sched_window``/
    ``sched_lag``; raises ``ValueError``."""
    head = progs[0]
    for p in progs[1:]:
        for attr in ("step_ms", "sched_window", "sched_lag"):
            if getattr(p, attr) != getattr(head, attr):
                raise ValueError(
                    f"program registry disagrees on {attr}: "
                    f"{type(head).__name__}={getattr(head, attr)} vs "
                    f"{type(p).__name__}={getattr(p, attr)} — registry "
                    "constants come from the primary program")
    return progs


def registry_unknown_params(progs, kv) -> set:
    """Param names no registered program declares."""
    names = set(kv)
    for p in as_programs(progs):
        names -= set(p.param_names)
    return names


def registry_width(progs) -> int:
    """Shared param-table width for a registry: the widest program."""
    return max(p.n_params for p in as_programs(progs))


def pad_row(row: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad one program row to the registry width (f32)."""
    row = np.asarray(row, np.float32)
    if row.shape[0] >= width:
        return row[:width]
    return np.concatenate([row, np.zeros((width - row.shape[0],),
                                         np.float32)])


# ----------------------------------------------------------- stock programs


class GraduatedThrottleProgram(PolicyProgram):
    """The paper's graduated allocator delay (§5): over-``high`` domains
    get ``min(max_delay, base_delay * (1 + gain * overage))`` ms, HIGH
    priority pays a discount, below-``low`` protection zeroes it."""

    param_names = ("base_delay_ms", "max_delay_ms", "overage_gain",
                   "high_priority_discount")

    def __init__(self, *, step_ms: float = 10.0,
                 base_delay_ms: float = BASE_DELAY_MS,
                 max_delay_ms: float = MAX_DELAY_MS,
                 overage_gain: float = OVERAGE_GAIN,
                 high_priority_discount: float = HIGH_PRIORITY_DISCOUNT):
        self.step_ms = step_ms
        self._defaults = (base_delay_ms, max_delay_ms, overage_gain,
                          high_priority_discount)

    @classmethod
    def from_config(cls, cfg) -> "GraduatedThrottleProgram":
        return cls(step_ms=cfg.step_ms, base_delay_ms=cfg.base_delay_ms,
                   max_delay_ms=cfg.max_delay_ms,
                   overage_gain=cfg.overage_gain,
                   high_priority_discount=cfg.high_priority_discount)

    def default_row(self) -> np.ndarray:
        return np.asarray(self._defaults, np.float32)

    def delay_ms(self, params, over_frac, priority=None, protected=False):
        params = torch.as_tensor(params, dtype=torch.float32)
        over_frac = torch.as_tensor(over_frac, dtype=torch.float32,
                                    device=params.device)
        d = torch.minimum(params[..., 1], params[..., 0] * fma(
            params[..., 2], over_frac, torch.ones_like(over_frac)))
        if priority is not None:
            d = torch.where(priority == D.HIGH, d * params[..., 3], d)
        protected = torch.as_tensor(protected, device=d.device)
        return torch.where(protected, torch.zeros_like(d), d)

    def on_over_high(self, view, req, over_frac, protected):
        return self.delay_ms(view.params, over_frac, view.priority, protected)


class TokenBucketProgram(GraduatedThrottleProgram):
    """Per-priority token-bucket admission on top of the graduated
    throttle: a domain with a configured bucket may only charge pages
    covered by accumulated tokens, refilled every step at a rate picked
    by the domain's priority.  ``bucket_capacity == 0`` (the neutral
    row) disables the bucket.  The bucket level and last refill step
    live in the param table, written back through ``Verdict.params``."""

    param_names = GraduatedThrottleProgram.param_names + (
        "bucket_level", "bucket_last_step", "bucket_capacity",
        "refill_low", "refill_normal", "refill_high")

    def __init__(self, *, bucket_capacity: float = 0.0,
                 refill: Sequence[float] = (1.0, 2.0, 4.0), **kw):
        super().__init__(**kw)
        self.bucket_capacity = float(bucket_capacity)
        self.refill = tuple(float(r) for r in refill)

    def default_row(self) -> np.ndarray:
        base = super().default_row()
        bucket = np.asarray(
            [self.bucket_capacity, 0.0, self.bucket_capacity] +
            list(self.refill), np.float32)
        return np.concatenate([base, bucket])

    def on_charge(self, view, req):
        base = super().on_charge(view, req)
        p = view.params
        cap = p[..., 6]
        enabled = cap > 0
        step_f = req.step.float()
        dt = torch.clamp(step_f - p[..., 5], min=0.0)
        refill = torch.where(view.priority == D.HIGH, p[..., 9],
                             torch.where(view.priority == D.NORMAL,
                                         p[..., 8], p[..., 7]))
        level = torch.minimum(cap, fma(dt, refill, p[..., 4]))
        amt_f = req.amt.float()
        have = level >= amt_f
        grant = base.grant & (~enabled | have)
        level = torch.where(grant & enabled, level - amt_f, level)
        newp = torch.cat([p[..., :4], level[..., None],
                          step_f.expand(level.shape)[..., None],
                          p[..., 6:]], dim=-1)
        return Verdict(grant,
                       base.stall | (base.grant & enabled & ~have),
                       base.delay_ms,
                       torch.where(enabled[..., None], newp, p))
