"""Fused enforcement kernels — the charge/account/gate hot path on Hopper.

Port of ``repro/kernels/enforcement.py`` (Pallas ``fused_charge_batch``
and ``fused_slot_gate``) as CUDA C++ in ``csrc/enforcement.cu``: the
charge stages only the domains its slots touch (their ancestor chains)
in shared memory, decides the slots in order in one thread, and copies
the untouched rest of the table across the grid; the gate runs one
thread per slot.  The source note there says what bounds the kernels
(launch latency and the serial slot chain, not bytes or operations) and
how the design answers it.

Both take an optional leading shard axis: a state of ``(S, n)`` columns
(``(S, n, P)`` parameters) with an ``(S, m)`` matrix of shard-local
slot indices (-1 off the shard) and shared ``(m,)`` amounts is charged
or gated per shard, all shards in one launch (the sharded backend's
in-step path, ``core/sharded.py``); a state of ``(n,)`` columns with
``(m,)`` slots is the same call at S = 1 (the device table's path).

The plain versions are ``core/controller.py``'s ``_plain_charge_batch``
and ``_plain_slot_gate`` (re-exported here as ``charge_batch_plain`` and
``slot_gate_plain``) and, over a shard axis, their per-shard loops
``_plain_charge_shards`` and ``_plain_gate_shards``: the wrappers take
them only for CPU tensors; for CUDA tensors they launch the kernel or
raise; tensors that hold no data take ``kernels/fake.py``'s branch, with
the work ``charge_cost`` and ``gate_cost`` count.  The stock programs'
decision code is compiled into the kernel, selected per registry slot by
a kind code; a registry holding any other program (a user subclass) has
no CUDA form and raises on CUDA, naming the program.

The launch path is lean because the charge runs once every engine step:
a registry's constants (kind codes, the f32 ``1 / step_ms``, the gate's
program test) are computed once per registry and kept; the checks
compare attributes without building messages unless one fails; the
seven outputs are views of one allocation (``charge_outputs``); the
kernel gets one output pointer; the stream handle is read without a
``Stream`` object.

This module is a decision module for tracelint purposes: the wrappers
admit no Python branches on tensor values and no suppression pragmas;
device dispatch, checks and ctypes glue live in the helpers below them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.controller import (DEPTH, _plain_charge_batch,
                                         _plain_charge_shards,
                                         _plain_gate_shards,
                                         _plain_slot_gate, step_reciprocal)
from repro_torch.core.progs import (GraduatedThrottleProgram, PolicyProgram,
                                    TokenBucketProgram, as_programs)
from repro_torch.core.sched import WeightedFairProgram
from repro_torch.kernels import _build, fake

charge_batch_plain = _plain_charge_batch
slot_gate_plain = _plain_slot_gate

# kind codes of csrc/enforcement.cu; matched on the exact type, so a
# subclass with its own hooks never borrows a stock program's code
_KIND_CODES = {PolicyProgram: 0, GraduatedThrottleProgram: 1,
               WeightedFairProgram: 1, TokenBucketProgram: 2}
_MAX_PARAMS = 16
_MAX_REGISTRY = 16
_INT_COLUMNS = ("parent", "high", "max", "low", "priority", "prog_id",
                "usage", "peak", "throttle_until", "mem_stall")

_P = ctypes.c_void_p
_I = ctypes.c_int


def fused_charge_batch(state: dict, dom, amt, step, prog=None):
    """Fused replacement for the plain ``charge_batch`` body: same
    signature, bit-identical ``(new_state, granted, stalled)``."""
    progs = as_programs(prog)
    return _charge_route(dom)(state, dom, amt, step, progs)


def fused_slot_gate(state: dict, slot_dom, step, prog=None):
    """Fused replacement for the plain ``slot_gate`` body."""
    progs = as_programs(prog)
    return _gate_route(slot_dom)(state, slot_dom, step, progs)


fused_charge_batch.launches = 0
fused_slot_gate.launches = 0


def _charge_route(dom):
    if dom.is_cuda or not fake.holds_data(dom):
        return _launch_charge
    return _plain_charge_batch if dom.dim() == 1 else _plain_charge_shards


def _gate_route(slot_dom):
    if slot_dom.is_cuda or not fake.holds_data(slot_dom):
        return _launch_gate
    return _plain_slot_gate if slot_dom.dim() == 1 else _plain_gate_shards


def kind_codes(progs) -> list:
    """The CUDA kind code of each registry slot; raises for a program
    that has no CUDA form."""
    codes = []
    for p in progs:
        code = _KIND_CODES.get(type(p))
        if code is None:
            raise NotImplementedError(
                f"{type(p).__name__} has no CUDA form: the fused "
                "enforcement kernel compiles in the stock programs "
                "(PolicyProgram, GraduatedThrottleProgram, "
                "TokenBucketProgram, WeightedFairProgram) only; run "
                "custom programs on CPU state (device='cpu')")
        codes.append(code)
    if len(codes) > _MAX_REGISTRY:
        raise ValueError(f"registry of {len(codes)} programs; the kernel "
                         f"takes at most {_MAX_REGISTRY}")
    return codes


# (program types, step_ms) -> registry constants; a pure function of
# its key, so entries never go stale
_REGISTRY: dict = {}


def registry_constants(progs) -> tuple:
    """``(kinds, n_kinds, inv_step, stock_gate)`` of a registry: the kind
    codes packed 4 bits a slot, their count, the f32 ``1 / step_ms``
    that ``step_reciprocal`` gives, and whether every program gates as
    ``PolicyProgram.on_gate`` does.  Computed once per registry; raises
    (every call) for a program with no CUDA form."""
    key = (tuple(map(type, progs)), progs[0].step_ms)
    hit = _REGISTRY.get(key)
    if hit is None:
        codes = kind_codes(progs)
        hit = (sum(c << (4 * i) for i, c in enumerate(codes)), len(codes),
               float(step_reciprocal(progs)),
               all(type(p).on_gate is PolicyProgram.on_gate
                   for p in progs))
        _REGISTRY[key] = hit
    return hit


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _ok(t: torch.Tensor, dtype, shape, device) -> bool:
    return (t.dtype is dtype and t.shape == shape and t.device == device
            and t.is_contiguous())


def charge_checks(state: dict, dom, amt) -> tuple:
    """Device, type, shape and contiguity of every tensor the charge
    kernel reads, with or without a leading shard axis (the same on
    every tensor but the shared amounts); ``(m, n, P)``.  Raises, naming
    the tensor, on what the kernel does not take."""
    dev = dom.device
    shape = state["usage"].shape           # (n,) or (S, n)
    n = shape[-1]
    m = dom.shape[-1]
    prog = state["prog"]
    P = prog.shape[-1]
    if P > _MAX_PARAMS:
        raise ValueError(f"param table width {P} > {_MAX_PARAMS}")
    if len(shape) > 2:
        raise ValueError(f"state columns of shape {tuple(shape)}: want "
                         "(n,) or (S, n)")
    i32 = torch.int32
    slots = shape[:-1] + (m,)
    ok = (_ok(dom, i32, slots, dev) and _ok(amt, i32, (m,), dev)
          and _ok(state["frozen"], torch.bool, shape, dev)
          and _ok(prog, torch.float32, shape + (P,), dev))
    for key in _INT_COLUMNS:
        ok = ok and _ok(state[key], i32, shape, dev)
    if not ok:
        _check(dom, "dom", i32, slots, dev)
        _check(amt, "amt", i32, (m,), dev)
        for key in _INT_COLUMNS:
            _check(state[key], key, i32, shape, dev)
        _check(state["frozen"], "frozen", torch.bool, shape, dev)
        _check(prog, "prog", torch.float32, shape + (P,), dev)
    return m, n, P


def charge_outputs(m: int, n: int, P: int, dev, lead=()) -> tuple:
    """One allocation of int32 words, carved as
    ``csrc/enforcement.cu::enforcement_charge`` lays it out for S shards
    (``lead = (S,)``; ``()`` is S = 1 without the axis): usage, peak,
    throttle_until, mem_stall (S n each), prog (S n P, f32), granted and
    stalled (S m bytes each, a uint8 region viewed as bool), then the
    chunk scratch (16 S m bytes from the next 16-byte boundary).  Returns
    ``(buffer, usage, peak, tu, stall, prog, granted, stalled)``, each
    view of shape ``lead + (n,)``, ``lead + (n, P)`` or ``lead + (m,)``."""
    if lead:
        n, m, S = n * lead[0], m * lead[0], lead[0]
    head = 4 * n + n * P
    scratch = (4 * head + 2 * m + 15) // 16 * 16
    words = (scratch + 16 * m) // 4 - head
    buf = torch.empty(head + words, dtype=torch.int32, device=dev)
    usage, peak, tu, stall, prog, rest = torch.split_with_sizes(
        buf, (n, n, n, n, n * P, words))
    flags = rest.view(torch.bool)
    if not lead:      # the device table's call: no more views (~20 µs)
        return (buf, usage, peak, tu, stall,
                prog.view(torch.float32).view(n, P), flags[:m],
                flags[m:2 * m])
    col, slots = (S, n // S), (S, m // S)
    return (buf, usage.view(col), peak.view(col), tu.view(col),
            stall.view(col), prog.view(torch.float32).view(col + (P,)),
            flags[:m].view(slots), flags[m:2 * m].view(slots))


def charge_call(state: dict, dom, amt, step, consts, m, n, P, buf,
                S: int = 1) -> None:
    """The ctypes call that launches the charge kernel into ``buf``."""
    kinds, n_kinds, inv_step, _ = consts
    err = _charge_lib().enforcement_charge(
        dom.data_ptr(), amt.data_ptr(), m, S, int(step), inv_step,
        state["parent"].data_ptr(), state["high"].data_ptr(),
        state["max"].data_ptr(), state["low"].data_ptr(),
        state["frozen"].data_ptr(), state["priority"].data_ptr(),
        state["prog_id"].data_ptr(), state["usage"].data_ptr(),
        state["peak"].data_ptr(), state["throttle_until"].data_ptr(),
        state["prog"].data_ptr(), state["mem_stall"].data_ptr(), n, P,
        kinds, n_kinds, buf.data_ptr(), _stream(dom.device))
    _build.check(err, "enforcement_charge")


def _launch_charge(state: dict, dom, amt, step, progs):
    consts = registry_constants(progs)
    m, n, P = charge_checks(state, dom, amt)
    lead = dom.shape[:-1]
    buf, usage, peak, tu, stall, params, granted, stalled = charge_outputs(
        m, n, P, dom.device, lead)
    if fake.holds_data(dom):
        charge_call(state, dom, amt, step, consts, m, n, P, buf,
                    lead[0] if lead else 1)
        fused_charge_batch.launches += 1
    else:
        fake.record("fused_charge_batch", charge_cost(state, dom))
    new_state = dict(state, usage=usage, peak=peak, throttle_until=tu,
                     prog=params, mem_stall=stall)
    return new_state, granted, stalled


def gate_checks(state: dict, slot_dom) -> tuple:
    """The gate kernel's tensors, as ``charge_checks``; ``(m, n)``."""
    dev = slot_dom.device
    shape = state["parent"].shape          # (n,) or (S, n)
    n = shape[-1]
    m = slot_dom.shape[-1]
    if len(shape) > 2:
        raise ValueError(f"state columns of shape {tuple(shape)}: want "
                         "(n,) or (S, n)")
    i32 = torch.int32
    slots = shape[:-1] + (m,)
    if not (_ok(slot_dom, i32, slots, dev)
            and _ok(state["parent"], i32, shape, dev)
            and _ok(state["throttle_until"], i32, shape, dev)
            and _ok(state["frozen"], torch.bool, shape, dev)):
        _check(slot_dom, "slot_dom", i32, slots, dev)
        for key in ("parent", "throttle_until"):
            _check(state[key], key, i32, shape, dev)
        _check(state["frozen"], "frozen", torch.bool, shape, dev)
    return m, n


def _launch_gate(state: dict, slot_dom, step, progs):
    if not registry_constants(progs)[3]:
        bad = [type(p).__name__ for p in progs
               if type(p).on_gate is not PolicyProgram.on_gate]
        raise NotImplementedError(f"{bad[0]}.on_gate has no CUDA form")
    m, n = gate_checks(state, slot_dom)
    lead = slot_dom.shape[:-1]
    out = torch.empty(lead + (m,), dtype=torch.bool, device=slot_dom.device)
    if fake.holds_data(slot_dom):
        gate_call(state, slot_dom, step, m, out, n, lead[0] if lead else 1)
        fused_slot_gate.launches += 1
    else:
        fake.record("fused_slot_gate", gate_cost(state, slot_dom))
    return out


def gate_call(state: dict, slot_dom, step, m, out, n: int,
              S: int = 1) -> None:
    """The ctypes call that launches the gate kernel into ``out``."""
    err = _gate_lib().enforcement_gate(
        slot_dom.data_ptr(), m, S, n, int(step), state["parent"].data_ptr(),
        state["frozen"].data_ptr(), state["throttle_until"].data_ptr(),
        out.data_ptr(), _stream(slot_dom.device))
    _build.check(err, "enforcement_gate")


def charge_cost(state: dict, dom, walks=None) -> dict:
    """The work of one charge, ``{ops, bytes, dtype}``
    (``timing.cost_bound_ms`` turns it into a bound): the slots and the
    amounts; parent, high, max, low, priority, prog_id and frozen of each
    touched domain; usage, peak, throttle_until, mem_stall and the
    parameter row of every domain, read and written; granted and stalled;
    ~40 operations a chain level.  ``walks`` is each shard's (domains
    touched, chain levels walked) where the caller has read the chains
    (``enforcement_bench.walks``); without it every slot walks ``DEPTH``
    levels of distinct domains.  The amounts are read once whatever the
    shard count."""
    n, P = state["prog"].shape[-2:]
    m = dom.shape[-1]
    if walks is None:
        walks = [(min(n, m * DEPTH), m * DEPTH)] * (
            dom.shape[0] if dom.dim() == 2 else 1)
    n_bytes = sum(m * 4 + touched * (6 * 4 + 1) + 2 * n * (4 * 4 + P * 4)
                  + 2 * m for touched, _ in walks)
    return {"ops": 40 * sum(levels for _, levels in walks),
            "bytes": n_bytes + m * 4, "dtype": torch.float32}


def gate_cost(state: dict, slot_dom, walks=None) -> dict:
    """The work of one gate, as ``charge_cost`` counts it: the slots,
    parent, frozen and throttle_until of each chain level, the flags; ~8
    operations a level."""
    m = slot_dom.shape[-1]
    if walks is None:
        walks = [(0, m * DEPTH)] * (
            slot_dom.shape[0] if slot_dom.dim() == 2 else 1)
    levels = sum(levels for _, levels in walks)
    return {"ops": 8 * levels, "bytes": len(walks) * m * 5 + levels * 9,
            "dtype": torch.float32}


def empty_launch(dev) -> None:
    """Launch ``csrc/enforcement.cu``'s empty kernel through the same
    ctypes path: the launch floor the two kernels are measured against.
    Counts nowhere."""
    lib = _build.load("enforcement")
    fn = lib.enforcement_empty
    if fn.argtypes is None:
        fn.argtypes = [_P]
        fn.restype = _I
    _build.check(fn(_stream(dev)), "enforcement_empty")


def _stream(dev) -> int:
    """The handle of the current CUDA stream on ``dev``: what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without
    building a ``Stream`` object (~3 µs a call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _charge_lib():
    lib = _build.load("enforcement")
    fn = lib.enforcement_charge
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _I, _I, ctypes.c_int32, ctypes.c_float]
                       + [_P] * 12 + [_I, _I, ctypes.c_ulonglong, _I]
                       + [_P, _P])
        fn.restype = _I
    return lib


def _gate_lib():
    lib = _build.load("enforcement")
    fn = lib.enforcement_gate
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _I, ctypes.c_int32, _P, _P, _P, _P, _P]
        fn.restype = _I
    return lib
