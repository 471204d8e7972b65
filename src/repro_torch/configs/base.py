"""Model configuration schema (port of ``repro/configs/base.py``).

A copy of the JAX package's dataclasses, so the port never imports the
reference (their fields as there; the published DeepSeek-V2's router,
expert share, leading dense layers and YaRN enter as init-only settings
of ``MoEConfig`` and ``MLAConfig``, and a section given as a mapping is
built into its dataclass), with the assigned input shapes (``SHAPES``;
the trainer takes its sequence length from ``train_4k``) and the rule
of which (arch x shape) cells apply (``cell_applicability``, identical to the reference's:
encoder-only archs have no decode step; ``long_500k`` needs sub-quadratic
context handling), which the dry run (``launch/dryrun.py``) follows.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import InitVar, dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (routed + optional shared experts).

    The fields are the JAX package's.  The init-only ones below carry the
    published DeepSeek-V2 router and the expert-parallel share of one
    card; they are read back as attributes of the same names, are not
    dataclass fields (so ``dataclasses.asdict`` and ``==`` see the JAX
    package's fields alone, and ``dataclasses.replace`` resets them), and
    their defaults give the JAX package's routing:

    * ``n_routed``: the experts the router ranks (its output width,
      ``router_width``); 0 means ``n_experts``.  ``n_experts`` is how
      many of them this card holds, ``first_expert`` the first held: the
      layer routes over all of them and computes its held experts' part
      of the result.
    * ``n_group`` / ``topk_group``: group-limited greedy routing, the top
      ``top_k`` taken among the experts of the ``topk_group`` groups with
      the highest best score (1 / 1: plain greedy).
    * ``norm_topk``: renormalise the top-k gates to sum 1; else the gates
      are the softmax probabilities times ``routed_scale``.
    * ``first_dense``: leading layers with a dense FFN of ``d_ff`` before
      the repeated groups (DeepSeek's ``first_k_dense_replace``).

    Each is kept as given (``dataclasses.replace`` carries them over), so
    a twin cut to fewer experts keeps ranking all of its own.
    """

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    period: int = 1          # MoE FFN on layers where (i % period) == period-1
    aux_coef: float = 0.01   # load-balance auxiliary loss coefficient
    router_dtype: str = "float32"
    n_routed: InitVar[int] = 0
    first_expert: InitVar[int] = 0
    n_group: InitVar[int] = 1
    topk_group: InitVar[int] = 1
    routed_scale: InitVar[float] = 1.0
    norm_topk: InitVar[bool] = True
    first_dense: InitVar[int] = 0

    def __post_init__(self, n_routed, first_expert, n_group, topk_group,
                      routed_scale, norm_topk, first_dense):
        width = n_routed or self.n_experts
        if not 0 <= first_expert <= width - self.n_experts:
            raise ValueError(f"experts {first_expert}.."
                             f"{first_expert + self.n_experts - 1} are not "
                             f"among the router's {width}")
        if width % n_group or not 1 <= topk_group <= n_group:
            raise ValueError(f"{width} experts in {n_group} groups, "
                             f"top {topk_group} groups")
        for k, v in (("n_routed", n_routed), ("first_expert", first_expert),
                     ("n_group", n_group), ("topk_group", topk_group),
                     ("routed_scale", float(routed_scale)),
                     ("norm_topk", bool(norm_topk)),
                     ("first_dense", first_dense)):
            object.__setattr__(self, k, v)

    @property
    def router_width(self) -> int:
        """The experts the router ranks: ``n_routed``, or every expert."""
        return self.n_routed or self.n_experts


@dataclass(frozen=True)
class YarnConfig:
    """YaRN rotary scaling (DeepSeek-V2's ``rope_scaling``, type yarn):
    the rotary frequencies blended between the base ones and the base
    ones over ``factor`` by a linear ramp over the dimensions whose
    rotations at ``original_max_position_embeddings`` lie between
    ``beta_slow`` and ``beta_fast``; cos/sin scaled by mscale(factor,
    mscale) / mscale(factor, mscale_all_dim) and the softmax by
    mscale(factor, mscale_all_dim) squared, mscale(s, m) = 0.1 m ln s + 1."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    type: str = "yarn"

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope scaling {self.type!r}: only yarn")


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2).

    KV is cached as a single ``kv_lora_rank + qk_rope_head_dim`` latent
    vector per token — the KV cache is ~9x smaller than GQA at kv=128.
    ``rope_scaling`` (init-only, read back as a ``YarnConfig`` or None,
    as ``MoEConfig``'s extras are) scales the rope dims' rotary table
    and the softmax as YaRN does; None keeps the plain table.
    """

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_scaling: InitVar[Optional[Mapping]] = None

    def __post_init__(self, rope_scaling):
        if isinstance(rope_scaling, Mapping):
            rope_scaling = YarnConfig(**rope_scaling)
        object.__setattr__(self, "rope_scaling", rope_scaling)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba (SSD/Mamba-2 chunked form) sub-config."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256         # intra-chunk parallel block for the SSD scan
    n_ssm_heads: int = 8     # SSD head count (d_inner split)


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_period: int = 8    # sLSTM at layers where (i % period) == period-1
    proj_factor: float = 2.0
    conv_kernel: int = 4
    chunk: int = 256         # mLSTM chunked-parallel block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid interleave: attention on layers where (i % attn_period) == attn_offset,
    # all other layers are Mamba blocks.  attn_period=1 -> all-attention.
    attn_period: int = 1
    attn_offset: int = 0
    encoder_only: bool = False
    frontend: Optional[str] = None   # None | "vision" | "audio"
    n_frontend_tokens: int = 0       # patch/frame embeddings supplied by input_specs
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time knobs
    remat: bool = True
    schedule: str = "cosine"         # cosine | wsd (minicpm)
    # scanning: layers are grouped into repeated groups of `group_size` layers;
    # the (attn/mamba/moe) pattern must be periodic in group_size.
    group_size: int = 1
    source: str = ""                 # provenance note [arXiv/hf; tier]

    def __post_init__(self):
        # nested sections given as mappings (a configuration file's
        # ``moe``, ``mla``, ``ssm`` or ``xlstm``) become their dataclasses
        for key, cls in (("moe", MoEConfig), ("mla", MLAConfig),
                         ("ssm", SSMConfig), ("xlstm", XLSTMConfig)):
            val = getattr(self, key)
            if isinstance(val, Mapping):
                object.__setattr__(self, key, cls(**val))

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def first_dense(self) -> int:
        """Leading dense layers before the repeated groups (0 without)."""
        return self.moe.first_dense if self.moe is not None else 0

    @property
    def n_groups(self) -> int:
        n = self.n_layers - self.first_dense
        assert n % self.group_size == 0, (self.name, self.n_layers, self.group_size)
        return n // self.group_size

    def layer_kinds(self) -> list[str]:
        """Sequence-mixer kind for each layer inside one scan group."""
        kinds = []
        for i in range(self.group_size):
            if self.xlstm is not None:
                kinds.append("slstm" if (i % self.xlstm.slstm_period) == self.xlstm.slstm_period - 1
                             else "mlstm")
            elif self.ssm is not None and self.attn_period > 1:
                kinds.append("attn" if (i % self.attn_period) == self.attn_offset else "mamba")
            elif self.ssm is not None:
                kinds.append("mamba")
            else:
                kinds.append("attn")
        return kinds

    def ffn_kinds(self) -> list[str]:
        """FFN kind ('dense' | 'moe' | 'none') for each layer in one group."""
        kinds = []
        for i in range(self.group_size):
            if self.d_ff == 0:
                kinds.append("none")
            elif self.moe is not None and (i % self.moe.period) == self.moe.period - 1:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return kinds

    @property
    def subquadratic(self) -> bool:
        """True when per-token decode state is O(1) or near-O(1) in context."""
        return self.family in ("hybrid", "ssm")

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, analytic."""
        d, hd = self.d_model, self.head_dim_
        n = 0
        # embeddings (+ untied head)
        n += self.padded_vocab * d
        if not self.tie_embeddings and not self.encoder_only:
            n += self.padded_vocab * d
        if self.encoder_only:
            n += d * self.padded_vocab  # classifier head
        kinds, ffns = self.layer_kinds(), self.ffn_kinds()
        per_group = 0
        lead = ([("attn", "dense")] * self.first_dense if self.first_dense
                else [])
        for i, (kind, ffn) in enumerate(list(zip(kinds, ffns)) + lead):
            if i == len(kinds):
                # the leading dense layers, counted once, not a group's
                n += per_group * self.n_groups
                per_group = 0
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    per_group += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.qk_rope_head_dim)
                    per_group += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    per_group += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    per_group += self.n_heads * m.v_head_dim * d
                else:
                    per_group += d * self.n_heads * hd          # Q
                    per_group += 2 * d * self.n_kv_heads * hd   # K, V
                    per_group += self.n_heads * hd * d          # O
            elif kind == "mamba":
                s = self.ssm
                d_in = s.expand * d
                per_group += d * 2 * d_in                       # in_proj (x, z)
                per_group += d_in * s.d_conv                    # conv
                per_group += d_in * 2 * s.d_state               # B, C proj (per SSD head shared)
                per_group += d_in + d_in                        # dt proj + A_log/D
                per_group += d_in * d                           # out_proj
            elif kind in ("mlstm", "slstm"):
                x = self.xlstm
                d_in = int(x.proj_factor * d)
                per_group += d * 2 * d_in + d_in * d            # up (x,z) + down
                per_group += 3 * d_in * d_in // 4               # q,k,v block-diag-ish
                per_group += 3 * d_in                           # gates
            if ffn == "dense":
                per_group += 3 * d * self.d_ff                  # SwiGLU
            elif ffn == "moe":
                m = self.moe
                n_routed = m.top_k if active_only else m.n_experts
                per_group += 3 * d * m.d_ff_expert * (n_routed + m.n_shared)
                per_group += d * m.router_width                 # router
        return n + per_group * (1 if lead else self.n_groups)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_applicability(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(applicable, reason-if-not), the reference's rule
    (``repro/configs/base.py:215-221``)."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic context (see DESIGN.md)"
    return True, ""
