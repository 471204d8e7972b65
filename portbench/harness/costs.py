"""Frozen copies of the program's cost arithmetic, and the card's peaks.

The benchmark's yardstick: what a kernel call or a model step has to
compute and move, and the rates of one NVIDIA H100 SXM from its data
sheet.  Each function is a copy of the port's as it stood when the
benchmark was defined (named beside it), written over plain shapes so it
needs no tensor:

* ``decode_cost``   ``repro_torch/kernels/decode_attention.py::cost``
* ``flash_cost``    ``repro_torch/kernels/flash_attention.py::cost``
* ``ssd_cost``      ``repro_torch/kernels/mamba_scan.py::cost``
* ``charge_cost``   ``repro_torch/kernels/enforcement.py::charge_cost``
* ``charge_walks``  ``repro_torch/kernels/enforcement_bench.py::walks``
* ``param_count``   ``repro_torch/configs/base.py::ModelConfig.param_count``
* ``model_flops``   ``repro_torch/analysis/roofline.py::model_flops``
* ``HW``            ``repro_torch/launch/mesh.py::HW``

A later change to the program's copies does not move these.
``portbench/tests/test_portbench_frozen.py`` holds them equal to the
program's functions.
"""
from __future__ import annotations

import subprocess

HW = {
    "name": "NVIDIA H100 SXM (data sheet)",
    "flops_bf16": 989e12,       # dense bf16 FLOP/s on the tensor cores
    "flops_f32": 67e12,         # f32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,          # HBM3 bytes/s
    "hbm_bytes": 80e9,          # HBM capacity
}

# bytes of an element by dtype name
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}
PEAK = {"bfloat16": HW["flops_bf16"], "float32": HW["flops_f32"]}


def bound_s(cost: dict) -> float:
    """The least time a piece of work can take on the card: the larger
    of its operations over the dtype's peak and its bytes over HBM."""
    return max(cost["ops"] / PEAK[cost["dtype"]],
               cost["bytes"] / HW["hbm_bw"])


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them;
    the peaks above assume the full 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi gave no line)"


# --------------------------------------------------------------- kernels


def decode_cost(B: int, H: int, hkv: int, dk: int, dv: int, lengths,
                dtype: str = "bfloat16") -> dict:
    """One dense decode call: each live K and V row read once, q read and
    out written, the int32 lengths; 2 (dk + dv) flops a live key and
    query head.  ``lengths`` are the live keys of each of the B rows."""
    live = sum(lengths)
    e = ELEM[dtype]
    n_bytes = e * (live * hkv * (dk + dv) + B * H * (dk + dv)) + 4 * B
    return {"ops": 2 * live * H * (dk + dv), "bytes": n_bytes,
            "dtype": dtype}


def flash_cost(B: int, S: int, H: int, dk: int, Sk: int, hkv: int, dv: int,
               *, causal: bool = True, dtype: str = "bfloat16") -> dict:
    """One flash forward: causal attends half the S x Sk pairs, 2 (dk +
    dv) flops a pair and query head; q, k, v read once, out and the f32
    lse written once."""
    e = ELEM[dtype]
    pairs = B * H * S * Sk / (2 if causal else 1)
    qkv = e * (B * S * H * dk + B * Sk * hkv * (dk + dv))
    out = e * B * S * H * dv
    lse = 4 * B * H * S
    return {"ops": 2 * pairs * (dk + dv), "bytes": qkv + out + lse,
            "dtype": dtype}


def ssd_cost(b: int, s: int, nh: int, dh: int, N: int, *, chunk: int = 256,
             dtype: str = "bfloat16") -> dict:
    """One SSD scan: x and y in x's dtype, dt and dt * A in f32, B and C
    in x's dtype, the f32 D and h_final; the products dense over each
    (chunk, head): C B^T, M x, C h^T and the state."""
    c = min(chunk, s)
    e = ELEM[dtype]
    n_bytes = (2 * e * b * s * nh * dh + 2 * 4 * b * s * nh
               + 2 * e * b * s * N + 4 * nh + 4 * b * nh * dh * N)
    n_ops = (s // c) * b * nh * (2 * c * c * N + 2 * c * c * dh
                                 + 2 * 2 * c * N * dh)
    return {"ops": n_ops, "bytes": n_bytes, "dtype": dtype}


def charge_cost(n: int, P: int, m: int, walks) -> dict:
    """One charge over an (n,)-domain table with P program parameters
    and m slots; ``walks`` is each shard's (domains touched, chain
    levels walked)."""
    n_bytes = sum(m * 4 + touched * (6 * 4 + 1) + 2 * n * (4 * 4 + P * 4)
                  + 2 * m for touched, _ in walks)
    return {"ops": 40 * sum(levels for _, levels in walks),
            "bytes": n_bytes + m * 4, "dtype": "float32"}


def charge_walks(parent, dom, depth: int = 4) -> tuple:
    """The (domains touched, chain levels walked) of one table's slots:
    each live slot's ancestor chain, at most ``depth`` levels; a dead
    slot touches the root."""
    chains = []
    for d in (int(x) for x in dom):
        chain, i = [], d
        while d >= 0 and i >= 0 and len(chain) < depth:
            chain.append(i)
            i = int(parent[i])
        chains.append(chain)
    touched = {x for c in chains for x in c} | (
        {0} if any(int(x) < 0 for x in dom) else set())
    return len(touched), sum(map(len, chains))


# ----------------------------------------------------------------- model


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_vocab(cfg: dict) -> int:
    return _round_up(cfg["vocab"], 256)


def layer_kinds(cfg: dict) -> list:
    """The sequence mixer of each layer of a group (attention or Mamba;
    the configurations the benchmark runs have no xLSTM)."""
    out = []
    for i in range(cfg["group_size"]):
        if cfg.get("ssm") and cfg.get("attn_period", 1) > 1:
            out.append("attn" if i % cfg["attn_period"] == cfg["attn_offset"]
                       else "mamba")
        elif cfg.get("ssm"):
            out.append("mamba")
        else:
            out.append("attn")
    return out


def ffn_kinds(cfg: dict) -> list:
    out = []
    for i in range(cfg["group_size"]):
        moe = cfg.get("moe")
        if cfg["d_ff"] == 0:
            out.append("none")
        elif moe and i % moe["period"] == moe["period"] - 1:
            out.append("moe")
        else:
            out.append("dense")
    return out


def param_count(cfg: dict, active_only: bool = False) -> int:
    """Total (or MoE-active) parameters, analytic: the embedding (and an
    untied head), then each layer's mixer and FFN."""
    d = cfg["d_model"]
    hd = cfg.get("head_dim") or d // cfg["n_heads"]
    V = padded_vocab(cfg)
    n = V * d
    if not cfg.get("tie_embeddings", False):
        n += V * d
    per_group = 0
    for kind, ffn in zip(layer_kinds(cfg), ffn_kinds(cfg)):
        if kind == "attn":
            per_group += d * cfg["n_heads"] * hd
            per_group += 2 * d * cfg["n_kv_heads"] * hd
            per_group += cfg["n_heads"] * hd * d
        else:
            s = cfg["ssm"]
            d_in = s["expand"] * d
            per_group += d * 2 * d_in
            per_group += d_in * s["d_conv"]
            per_group += d_in * 2 * s["d_state"]
            per_group += d_in + d_in
            per_group += d_in * d
        if ffn == "dense":
            per_group += 3 * d * cfg["d_ff"]
        elif ffn == "moe":
            m = cfg["moe"]
            n_routed = m["top_k"] if active_only else m["n_experts"]
            per_group += 3 * d * m["d_ff_expert"] * (n_routed
                                                     + m.get("n_shared", 0))
            per_group += d * m["n_experts"]
    return n + per_group * (cfg["n_layers"] // cfg["group_size"])


def model_flops(cfg: dict, kind: str, batch: int, seq: int) -> float:
    """The program's rule for useful compute: 2 N D for a prefill, 2 N B
    for a decode step (one token a slot), N the active parameters."""
    n_active = param_count(cfg, active_only=True)
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch


def attention_layers(cfg: dict) -> int:
    return (layer_kinds(cfg).count("attn")
            * (cfg["n_layers"] // cfg["group_size"]))


def token_flops(cfg: dict, context: int) -> float:
    """Useful compute of one token decoded against ``context`` live keys
    (itself included): ``model_flops`` of one decode less the embedding
    gather, which multiplies nothing, plus 2 (dk + dv) flops a live key,
    query head and attention layer."""
    d = cfg["d_model"]
    hd = cfg.get("head_dim") or d // cfg["n_heads"]
    gather = 0 if cfg.get("tie_embeddings", False) else padded_vocab(cfg) * d
    dense = model_flops(cfg, "decode", 1, 1) - 2.0 * gather
    return dense + attention_layers(cfg) * 2.0 * context * cfg["n_heads"] * (
        2 * hd)


def prefill_flops(cfg: dict, seq: int, batch: int = 1) -> float:
    """Useful compute of a causal prefill: ``model_flops`` less the
    embedding gather, plus causal attention (half the S x S pairs, 2 (dk
    + dv) flops a pair and query head) in each attention layer."""
    d = cfg["d_model"]
    hd = cfg.get("head_dim") or d // cfg["n_heads"]
    gather = 0 if cfg.get("tie_embeddings", False) else padded_vocab(cfg) * d
    dense = model_flops(cfg, "prefill", batch, seq) - 2.0 * gather * batch * seq
    attn = flash_cost(batch, seq, cfg["n_heads"], hd, seq, cfg["n_kv_heads"],
                      hd)["ops"]
    return dense + attention_layers(cfg) * attn
