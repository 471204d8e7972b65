"""Three-term roofline of a counted step on one H100 (port of
``repro/analysis/roofline.py``, with ``launch/mesh.py::HW``).

    compute    = counted FLOPs / peak bf16 FLOP/s
    memory     = counted bytes / HBM bandwidth
    collective = 0 (one card: no collective)

The counts come from ``analysis/costs.py`` over one call of the step on
meta tensors: every aten op and kernel call as often as it runs, where
the reference reads trip-count-corrected HLO.  MODEL_FLOPS is the
analytic useful compute:
  train   : 6 * N * D        (N = params, active-only for MoE; D = tokens)
  prefill : 2 * N * D
  decode  : 2 * N * B        (one token per slot)
The ratio MODEL_FLOPS / counted FLOPs exposes remat recompute, MoE
capacity padding and attention beyond the 6 N D rule.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HW


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch        # decode: 1 token/slot


def mla_decode_flops(cfg: ModelConfig, context: int,
                     assigned: float = 0.0) -> float:
    """Useful compute of one token an MLA model decodes against
    ``context`` live keys (itself included), in the absorbed form its
    decode runs, with ``assigned`` routed assignments on the experts the
    card holds: each attention layer's q path (down, up), latent and rope
    projection, W_UK into the latent space, 2 H (L + rope) flops a live
    key for the scores and 2 H L for the latent output, W_UV and W_O;
    each dense FFN; each MoE layer's router and shared experts; the
    output head; and 6 d f a routed assignment.  The embedding gather
    multiplies nothing."""
    d, H, m, e = cfg.d_model, cfg.n_heads, cfg.mla, cfg.moe
    L, r = m.kv_lora_rank, m.qk_rope_head_dim
    attn = 2.0 * (d * m.q_lora_rank
                  + m.q_lora_rank * H * (m.qk_nope_head_dim + r)
                  + d * (L + r) + H * m.qk_nope_head_dim * L
                  + H * L * m.v_head_dim + H * m.v_head_dim * d)
    attn += context * (2.0 * H * (L + r) + 2.0 * H * L)
    n_attn = cfg.first_dense + cfg.layer_kinds().count("attn") * cfg.n_groups
    flops = n_attn * attn + 2.0 * d * cfg.padded_vocab
    ffns = cfg.ffn_kinds()
    flops += (cfg.first_dense + ffns.count("dense") * cfg.n_groups) * (
        6.0 * d * cfg.d_ff)
    if e is not None:
        flops += ffns.count("moe") * cfg.n_groups * (
            2.0 * d * e.router_width + 6.0 * d * e.d_ff_expert * e.n_shared)
        flops += assigned * 6.0 * d * e.d_ff_expert
    return flops


def roofline_from_costs(cfg: ModelConfig, shape: ShapeConfig, parsed: dict,
                        *, n_chips: int = 1) -> dict:
    """The reference's record from counted costs (``parsed``: the
    ``flops``, ``bytes`` and ``coll_bytes_total`` of
    ``CostCounter.result``).  ``hlo_flops_global`` keeps the reference's
    key and holds the counted flops times ``n_chips`` (1): no HLO is
    read.  The collective term is 0 on one card."""
    flops = parsed["flops"]
    byts = parsed["bytes"]
    compute_s = flops / HW["flops_bf16"]
    memory_s = byts / HW["hbm_bw"]
    collective_s = 0.0
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = flops * n_chips
    step_s = max(compute_s, memory_s, collective_s)
    ideal_s = mf / (n_chips * HW["flops_bf16"])
    return {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_flop_ratio": (mf / hlo_global) if hlo_global else 0.0,
        # fraction of the compute roofline this step achieves if the
        # dominant term is the critical path (no overlap assumed)
        "roofline_fraction": (ideal_s / step_s) if step_s else 0.0,
        "step_time_bound_s": step_s,
    }


def enforcement_roofline(n_domains: int = 64, batch: int = 32) -> dict:
    """The in-step charge at one shape, the plain route against the
    fused kernel, each counted by ``CostCounter`` over one call on meta
    tensors and bounded with ``HW``: the reference's record and keys.
    ``"lax"`` keeps the reference's name for the plain route: the port's
    plain charge (``core/controller.py::_plain_charge_batch``, the CPU
    path and the kernel's reference) is its port of ``_lax_charge_batch``
    and runs as aten ops, each counted (on the host table: its slot loop
    reads each slot's domain as an index, which a meta tensor cannot
    give); ``"fused"`` is the CUDA kernel on the same table on the meta
    device, counted by its ``charge_cost`` for slots that each walk the
    whole chain depth (a meta table has no chains to read).  The hot path is
    control-state sized (KBs): both sit far under the memory roofline,
    and the kernel's gain is fewer passes over the table
    (``bytes_ratio``)."""
    import torch

    from repro_torch.analysis.costs import CostCounter
    from repro_torch.core import controller as C
    from repro_torch.core.cgroup import (AgentCgroup, DeviceTableBackend,
                                         DomainSpec)
    from repro_torch.core.progs import (GraduatedThrottleProgram,
                                        TokenBucketProgram)
    from repro_torch.kernels.enforcement import fused_charge_batch

    cg = AgentCgroup(DeviceTableBackend(1 << 20, n_domains=n_domains,
                                        device="cpu"))
    cg.attach("/", GraduatedThrottleProgram())
    cg.mkdir("/grad", DomainSpec(high=1000))
    cg.mkdir("/bkt")
    cg.attach("/bkt", TokenBucketProgram(bucket_capacity=64,
                                         refill=(1.0, 1.0, 1.0)))
    progs = cg.programs
    state = cg.device_view().state
    dom = torch.tensor([cg.handle("/grad"), cg.handle("/bkt")] * (batch // 2)
                       + [cg.handle("/grad")] * (batch % 2),
                       dtype=torch.int32)
    amt = torch.ones(batch, dtype=torch.int32)
    meta = {"state": {k: v.to("meta") for k, v in state.items()},
            "dom": dom.to("meta"), "amt": amt.to("meta")}

    out: dict = {"n_domains": n_domains, "batch": batch,
                 "n_programs": len(progs), "device": HW["name"]}
    for name, fn, device, args in (
            ("lax", C._plain_charge_batch, "cpu", (state, dom, amt)),
            ("fused", fused_charge_batch, "meta", tuple(meta.values()))):
        with CostCounter(device) as cc:
            fn(*args, 0, progs)
        flops, byts = cc.flops, cc.bytes
        out[name] = {"flops": flops, "bytes": byts,
                     "compute_s": flops / HW["flops_bf16"],
                     "memory_s": byts / HW["hbm_bw"]}
    if out["lax"]["bytes"] and out["fused"]["bytes"]:
        out["bytes_ratio"] = out["fused"]["bytes"] / out["lax"]["bytes"]
    return out


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"
