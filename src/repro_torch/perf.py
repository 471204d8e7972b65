"""Runtime knobs of the trainer, separate from architecture configs
(port of the training fields of ``repro/perf.py``).

The attention implementation and block sizes of the reference have no
counterpart: the port has one flash implementation, and the wrapper
picks the kernel or the plain version by the tensors' device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class PerfConfig:
    # rematerialisation of each layer group: none | dots | full
    remat: str = "dots"
    grad_compress: bool = False  # int8 quantization with error feedback
    microbatches: int = 1        # gradient-accumulation splits


DEFAULT_PERF = PerfConfig()


def replace(perf: PerfConfig, **kw) -> PerfConfig:
    return dataclasses.replace(perf, **kw)
