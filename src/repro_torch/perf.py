"""Runtime knobs, separate from architecture configs (port of
``repro/perf.py``: the remat, training, MoE-dispatch and scan fields).

The attention implementation and block sizes of the reference have no
counterpart: the port has one flash implementation, and the wrapper
picks the kernel or the plain version by the tensors' device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    # MoE dispatch: a2a (all-to-all expert parallelism; without a mesh,
    # as on one card, it resolves to gather as in the reference), gather
    # (capacity dispatch), dense (masked all-experts comparison)
    moe_impl: str = "a2a"
    capacity_factor: float = 1.25
    # rematerialisation of each layer group: none | dots | full
    remat: str = "dots"
    grad_compress: bool = False  # int8 quantization with error feedback
    microbatches: int = 1        # gradient-accumulation splits
    # ssm chunked-scan block
    scan_chunk: int = 256


DEFAULT_PERF = PerfConfig()


def replace(perf: PerfConfig, **kw) -> PerfConfig:
    return dataclasses.replace(perf, **kw)
