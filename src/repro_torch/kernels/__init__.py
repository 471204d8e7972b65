"""Hand-written CUDA kernels of the port and their plain torch versions.

  enforcement       — fused hierarchical charge and slot gate
                      (csrc/enforcement.cu)
  decode_attention  — one-token GQA flash-decoding over a dense or a paged
                      cache (csrc/decode_attention.cu)
  flash_attention   — full-sequence flash forward and backward, joined in
                      an autograd Function (csrc/flash_attention.cu)
  mamba_scan        — the chunked SSD (Mamba-2) scan forward
                      (csrc/mamba_scan.cu)
  mla_decode        — one-token absorbed MLA decode over a latent cache
                      (csrc/mla_decode.cu)
  ssd_ablation      — where the bf16 SSD scan's time goes: its kernels
                      timed on the card with one part of the work cut
  decode_bench      — the bf16 decode kernels timed cold on the card, at
                      the engine's short contexts, filled caches and a
                      long context, beside another checkout's
  timing            — the card's rates and bounds, its name and power
                      limit, CUDA-event and profiler clocks
  ref               — plain torch oracles
  ops               — the per-op entry points the models call

Each wrapper counts the launches of its kernel in a ``launches``
attribute; ``launch_counts``/``reset_launch_counts`` read and zero them,
and ``add_launches`` counts launches that no wrapper's Python ran (a
CUDA graph's replay).
"""
from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.enforcement import (fused_charge_batch,
                                                 fused_slot_gate)
    from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
    from repro_torch.kernels.mamba_scan import ssd_scan
    from repro_torch.kernels.mla_decode import mla_decode
    return {"fused_charge_batch": fused_charge_batch,
            "fused_slot_gate": fused_slot_gate,
            "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
            "ssd_scan": ssd_scan, "mla_decode": mla_decode}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (a wrapper's name -> launches) to the
    wrappers' counters."""
    fns = _wrappers()
    for name, n in counts.items():
        fns[name].launches += times * n
