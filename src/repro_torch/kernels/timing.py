"""Clocks and bounds for the port's kernels on the card, shared by
``chip_smoke.py`` and the studies in this package (``decode_bench``,
``ssd_ablation``): the H100's data-sheet rates (``launch/mesh.py::HW``)
and the least time a piece of work can take at them (the one place that
divides by them), the card's name and power limit, the time a
call from CUDA events (the issue pace: the slower of the host issuing
calls and the device running them), and each kernel's device time from
``torch.profiler``.  Nothing here touches the card at import time.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.launch.mesh import HW

# the card's HBM3 bandwidth and dense bf16 and f32 peaks (``HW``)
MEM_BYTES_PER_S = HW["hbm_bw"]
PEAK_OPS_PER_S = {torch.bfloat16: HW["flops_bf16"],
                  torch.float32: HW["flops_f32"]}


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """The larger of ``n_bytes`` over the memory rate and ``n_ops`` over
    the peak rate of ``dtype``, in ms, and which of the two it is."""
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cost_bound_ms(cost: dict) -> tuple[float, str]:
    """``bound_ms`` of a kernel's ``cost(...)``: ``{ops, bytes,
    dtype}``."""
    return bound_ms(cost["bytes"], cost["ops"], cost["dtype"])


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean time of one ``fn()`` from CUDA events around ``iters`` calls
    issued back to back, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int) -> dict:
    """Each kernel that ``iters`` calls of ``fn()`` launch, from
    ``torch.profiler``: ``{name: (device ms a call, launches a call)}``.
    Raises if the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {e.key: (e.self_device_time_total / 1e3 / iters, e.count / iters)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    if not out:
        raise AssertionError("the profiler saw no kernel")
    return out
