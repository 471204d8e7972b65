"""Fused enforcement kernels — the charge/account/gate hot path on Hopper.

Port of ``repro/kernels/enforcement.py`` (Pallas ``fused_charge_batch``
and ``fused_slot_gate``) as CUDA C++ in ``csrc/enforcement.cu``: one CTA
holds the ``(n_domains,)`` control table and the ``(n, P)`` parameter
table in shared memory while one thread walks the request slots in
order; the gate runs one thread per slot.  The source note there says
what bounds the kernels (launch latency and the serial slot chain, not
bytes or operations) and how the design answers it.

The plain versions are ``core/controller.py``'s ``_plain_charge_batch``
and ``_plain_slot_gate`` (re-exported here as ``charge_batch_plain`` and
``slot_gate_plain``): the wrappers take them only for CPU tensors; for
CUDA tensors they launch the kernel or raise.  The stock programs'
decision code is compiled into the kernel, selected per registry slot by
a kind code; a registry holding any other program (a user subclass) has
no CUDA form and raises on CUDA, naming the program.

This module is a decision module for tracelint purposes: the wrappers
admit no Python branches on tensor values and no suppression pragmas;
device dispatch, checks and ctypes glue live in the helpers below them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.controller import (_plain_charge_batch,
                                         _plain_slot_gate, step_reciprocal)
from repro_torch.core.progs import (GraduatedThrottleProgram, PolicyProgram,
                                    TokenBucketProgram, as_programs)
from repro_torch.core.sched import WeightedFairProgram
from repro_torch.kernels import _build

charge_batch_plain = _plain_charge_batch
slot_gate_plain = _plain_slot_gate

# kind codes of csrc/enforcement.cu; matched on the exact type, so a
# subclass with its own hooks never borrows a stock program's code
_KIND_CODES = {PolicyProgram: 0, GraduatedThrottleProgram: 1,
               WeightedFairProgram: 1, TokenBucketProgram: 2}
_MAX_PARAMS = 16
_MAX_REGISTRY = 16

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
    return _launch_charge if dom.is_cuda else _plain_charge_batch


def _gate_route(slot_dom):
    return _launch_gate if slot_dom.is_cuda else _plain_slot_gate


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


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_charge(state: dict, dom, amt, step, progs):
    codes = kind_codes(progs)
    m = dom.shape[0]
    n = state["usage"].shape[0]
    P = state["prog"].shape[1]
    dev = dom.device
    if P > _MAX_PARAMS:
        raise ValueError(f"param table width {P} > {_MAX_PARAMS}")
    _check(dom, "dom", torch.int32, (m,), dev)
    _check(amt, "amt", torch.int32, (m,), dev)
    for key in ("parent", "high", "max", "low", "priority", "prog_id",
                "usage", "peak", "throttle_until", "mem_stall"):
        _check(state[key], key, torch.int32, (n,), dev)
    _check(state["frozen"], "frozen", torch.bool, (n,), dev)
    _check(state["prog"], "prog", torch.float32, (n, P), dev)
    lib = _charge_lib()
    usage = torch.empty_like(state["usage"])
    peak = torch.empty_like(state["peak"])
    tu = torch.empty_like(state["throttle_until"])
    params = torch.empty_like(state["prog"])
    stall = torch.empty_like(state["mem_stall"])
    granted = torch.empty(m, dtype=torch.bool, device=dev)
    stalled = torch.empty(m, dtype=torch.bool, device=dev)
    kinds = sum(c << (4 * i) for i, c in enumerate(codes))
    err = lib.enforcement_charge(
        dom.data_ptr(), amt.data_ptr(), m, int(step),
        float(step_reciprocal(progs)), state["parent"].data_ptr(),
        state["high"].data_ptr(), state["max"].data_ptr(),
        state["low"].data_ptr(), state["frozen"].data_ptr(),
        state["priority"].data_ptr(), state["prog_id"].data_ptr(),
        state["usage"].data_ptr(), state["peak"].data_ptr(),
        state["throttle_until"].data_ptr(), state["prog"].data_ptr(),
        state["mem_stall"].data_ptr(), n, P, kinds, len(codes),
        usage.data_ptr(), peak.data_ptr(), tu.data_ptr(), params.data_ptr(),
        stall.data_ptr(), granted.data_ptr(), stalled.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "enforcement_charge")
    fused_charge_batch.launches += 1
    new_state = dict(state, usage=usage, peak=peak, throttle_until=tu,
                     prog=params, mem_stall=stall)
    return new_state, granted, stalled


def _launch_gate(state: dict, slot_dom, step, progs):
    kind_codes(progs)
    for p in progs:
        if type(p).on_gate is not PolicyProgram.on_gate:
            raise NotImplementedError(
                f"{type(p).__name__}.on_gate has no CUDA form")
    m = slot_dom.shape[0]
    n = state["usage"].shape[0]
    dev = slot_dom.device
    _check(slot_dom, "slot_dom", torch.int32, (m,), dev)
    for key in ("parent", "throttle_until"):
        _check(state[key], key, torch.int32, (n,), dev)
    _check(state["frozen"], "frozen", torch.bool, (n,), dev)
    lib = _gate_lib()
    out = torch.empty(m, dtype=torch.bool, device=dev)
    err = lib.enforcement_gate(
        slot_dom.data_ptr(), m, int(step), state["parent"].data_ptr(),
        state["frozen"].data_ptr(), state["throttle_until"].data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "enforcement_gate")
    fused_slot_gate.launches += 1
    return out


def _charge_lib():
    lib = _build.load("enforcement")
    fn = lib.enforcement_charge
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _I, ctypes.c_int32, ctypes.c_float]
                       + [_P] * 12 + [_I, _I, ctypes.c_ulonglong, _I]
                       + [_P] * 7 + [_P])
        fn.restype = _I
    return lib


def _gate_lib():
    lib = _build.load("enforcement")
    fn = lib.enforcement_gate
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, ctypes.c_int32, _P, _P, _P, _P, _P]
        fn.restype = _I
    return lib
