"""The hardware table of the port (``repro/launch/mesh.py::HW``): one
NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no sparsity, at
the card's full 700 W power limit).

The reference's ``make_production_mesh``, ``rules_for`` and
``POD_CHIPS`` have no counterpart: they lay a model out over a TPU pod
(FSDP and tensor parallelism over a 16 x 16 mesh, a second pod across
the data-centre network), while the port runs on one card and shards
nothing, so no collective crosses a link and the table has no link
rates.  ``kernels/timing.py`` reads its peaks from ``HW``, and so do the
roofline (``analysis/roofline.py``) and the dry run
(``launch/dryrun.py``).
"""
from __future__ import annotations

HW = {
    "name": "NVIDIA H100 SXM (data sheet)",
    "flops_bf16": 989e12,       # dense bf16 FLOP/s on the tensor cores
    "flops_f32": 67e12,         # f32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,          # HBM3 bytes/s
    "hbm_bytes": 80e9,          # HBM capacity
}
