"""Frozen copies of the program's costs of an MLA decode, the yardsticks
of ``step.mfu.serve_mla`` and ``mla_decode.roofline``:

* ``mla_decode_flops``  ``repro_torch/analysis/roofline.py::mla_decode_flops``
* ``mla_decode_cost``   ``repro_torch/kernels/mla_decode.py::cost``

written over the configuration's file (a dict) as it stood when the
metric was defined.  A later change to the program's copy does not move
it; ``portbench/tests/test_portbench_deepseek.py`` holds the two equal.
"""
from __future__ import annotations

from portbench.harness.costs import (ELEM, ffn_kinds, layer_kinds,
                                     padded_vocab)


def mla_decode_flops(cfg: dict, context: int, assigned: float = 0.0) -> float:
    """Useful compute of one token decoded against ``context`` live keys
    (itself included) in the absorbed form, with ``assigned`` routed
    assignments on the held experts: per attention layer the q path
    (down, up), the latent and rope projection, W_UK into the latent
    space, 2 H (L + rope) flops a live key for the scores and 2 H L for
    the latent output, W_UV and W_O; the dense FFNs; each MoE layer's
    router (over its ``n_routed`` outputs) and shared experts; the output
    head; 6 d f a routed assignment."""
    d, H, m, e = cfg["d_model"], cfg["n_heads"], cfg["mla"], cfg.get("moe")
    L, r = m["kv_lora_rank"], m["qk_rope_head_dim"]
    nope, v = m["qk_nope_head_dim"], m["v_head_dim"]
    lead = e.get("first_dense", 0) if e else 0
    groups = (cfg["n_layers"] - lead) // cfg["group_size"]
    attn = 2.0 * (d * m["q_lora_rank"] + m["q_lora_rank"] * H * (nope + r)
                  + d * (L + r) + H * nope * L + H * L * v + H * v * d)
    attn += context * (2.0 * H * (L + r) + 2.0 * H * L)
    n_attn = lead + layer_kinds(cfg).count("attn") * groups
    flops = n_attn * attn + 2.0 * d * padded_vocab(cfg)
    ffns = ffn_kinds(cfg)
    flops += (lead + ffns.count("dense") * groups) * 6.0 * d * cfg["d_ff"]
    if e:
        routed = e.get("n_routed") or e["n_experts"]
        flops += ffns.count("moe") * groups * (
            2.0 * d * routed + 6.0 * d * e["d_ff_expert"] * e["n_shared"])
        flops += assigned * 6.0 * d * e["d_ff_expert"]
    return flops


def mla_decode_cost(B: int, H: int, L: int, R: int, lengths,
                    dtype: str = "bfloat16") -> dict:
    """One latent decode call: each live latent row (L + R numbers) read
    once for every head, q read and out written, the int32 lengths and
    order; 2 (L + R) flops a live row and head for the scores and 2 L
    for the output.  ``lengths`` are the live rows of each of the B
    slots."""
    live = sum(lengths)
    n_bytes = ELEM[dtype] * (live * (L + R) + B * H * (2 * L + R)) + 8 * B
    return {"ops": 2 * live * H * (2 * L + R), "bytes": n_bytes,
            "dtype": dtype}
