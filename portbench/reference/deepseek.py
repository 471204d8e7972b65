"""Plain float32 reference of the DeepSeek-V2 decoder on one card's share
of an expert-parallel deployment, as the published block computes it
(``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2, arXiv:2405.04434).

Each layer: RMSNorm, multi-head latent attention, a residual add,
RMSNorm, an FFN, a residual add; the first ``moe.first_dense`` layers
take a dense SwiGLU FFN of ``d_ff``, the others the MoE FFN; then a
final RMSNorm and the untied output head over the padded vocabulary.

Attention (not absorbed: K and V expanded per head from the latent):

    c_q = RMSNorm(x W_DQ),  [q_nope, q_rope] = c_q W_UQ          (per head)
    [c_kv, k_rope] = x W_DKV,  c_kv = RMSNorm(c_kv)
    k_nope = c_kv W_UK,  v = c_kv W_UV                           (per head)
    q_rope, k_rope rotated (k_rope one for all heads)
    o = softmax(s (q_nope k_nope + q_rope k_rope)) v,  out = o W_O

under a causal mask, with YaRN's rotary frequencies and the softmax
scale ``s = (nope + rope) ** -0.5 * mscale(factor, mscale_all_dim) ** 2``.

MoE: a float32 softmax over the router's ``n_routed`` outputs; the
``topk_group`` groups (of ``n_group``) with the highest best probability
kept and the other groups' probabilities zeroed; the top ``top_k``
probabilities, not renormalised, times ``routed_scale``; every
assignment computed (no capacity, nothing dropped); only the experts
this card holds (``first_expert`` .. ``first_expert + n_experts - 1``)
add their part, as the card computes its share; the shared experts
(one SwiGLU of ``n_shared * d_ff_expert``) added whole.

Departures from the published model, each as the program has it: the
rotary dims of q and k are rotated as two halves (the published code
first de-interleaves the pairs), a fixed permutation of the rope
columns of W_UQ and W_DKV, which random weights do not tell apart; the
experts not held here add nothing (they lie on the deployment's other
cards).

The weights arrive as the benchmark drew them: the leading dense layers
in ``lead`` and the MoE layers in ``groups``, each stacked on a leading
layer axis.  Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Weights, exact_float32, rmsnorm, swiglu

BLOCK = 256
# the leaves that multiply (the float8 control rounds these): the norms'
# scales and the router (float32 in the published gate) stay as drawn
NOT_PRODUCTS = ("scale", "q_norm", "kv_norm", "router")


def _pick(tree: dict, i: int) -> dict:
    return {k: (_pick(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def layer(params: dict, cfg: dict, i: int) -> tuple:
    """(``dense`` or ``moe``, the weights of layer i)."""
    lead = cfg["moe"].get("first_dense", 0)
    if i < lead:
        return "dense", _pick(params["lead"], i)
    return "moe", _pick(params["groups"][0], i - lead)


def products(tree: dict, W: Weights) -> dict:
    """A layer's weights as the reference multiplies with them, each
    weight matrix made float32 (or rounded for the control) once."""
    return {k: (products(v, W) if isinstance(v, dict) else
                v if k in NOT_PRODUCTS else W.w(v))
            for k, v in tree.items()}


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, yarn: dict | None):
    """float64 (dim/2,) rotary frequencies and the cos/sin scale:
    DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``."""
    half = dim // 2
    base = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    if not yarn:
        return base, 1.0
    orig = yarn["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            theta))
    low = max(math.floor(corr(yarn.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr(yarn.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float64) - low)
                       / (high - low), 0, 1)
    inv = base / yarn["factor"] * ramp + base * (1 - ramp)
    scale = (mscale(yarn["factor"], yarn.get("mscale", 1))
             / mscale(yarn["factor"], yarn.get("mscale_all_dim", 0)))
    return inv, scale


def softmax_scale(cfg: dict) -> float:
    m = cfg["mla"]
    s = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    y = m.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        s *= mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return s


def rope(x, positions, inv, scale: float):
    """x (L, H, r) rotated as two halves: pair i of position p by the
    angle p * inv[i]; cos and sin times ``scale``."""
    half = x.shape[-1] // 2
    ang = positions.double()[:, None] * inv.to(x.device)[None]
    cos = (torch.cos(ang) * scale).float()[:, None, :]
    sin = (torch.sin(ang) * scale).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: dict, p: dict, x, pos, W: Weights):
    """Latent attention over the whole sequence x (L, d), causal."""
    m = cfg["mla"]
    H, L = cfg["n_heads"], m["kv_lora_rank"]
    nd, rd, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                  m["v_head_dim"])
    eps = cfg["norm_eps"]
    inv, cs = yarn_freqs(rd, cfg["rope_theta"], m.get("rope_scaling"))
    T = x.shape[0]
    cq = rmsnorm(W.mm(x, p["w_dq"]), p["q_norm"], eps)
    q = W.mm(cq, p["w_uq"].reshape(cq.shape[1], -1)).view(T, H, nd + rd)
    kv = W.mm(x, p["w_dkv"])
    ckv = rmsnorm(kv[:, :L], p["kv_norm"], eps)
    k_rope = rope(kv[:, None, L:], pos, inv, cs)               # (T, 1, rd)
    k_nope = W.mm(ckv, p["w_uk"].reshape(L, -1)).view(T, H, nd)
    v = W.mm(ckv, p["w_uv"].reshape(L, -1)).view(T, H, vd)
    q = torch.cat([q[..., :nd], rope(q[..., nd:], pos, inv, cs)], -1)
    k = torch.cat([k_nope, k_rope.expand(T, H, rd)], -1)
    scale = softmax_scale(cfg)
    kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)            # (H, T, *)
    o = torch.empty(T, H, vd, dtype=torch.float32, device=x.device)
    for r0 in range(0, T, BLOCK):
        r1 = min(T, r0 + BLOCK)
        s = (q[r0:r1].permute(1, 0, 2) @ kh[:, :r1].transpose(1, 2)) * scale
        rows = torch.arange(r0, r1, device=x.device)[:, None]
        cols = torch.arange(r1, device=x.device)[None]
        s = s.masked_fill(cols > rows, float("-inf"))
        o[r0:r1] = (torch.softmax(s, -1) @ vh[:, :r1]).permute(1, 0, 2)
    return W.mm(o.reshape(T, H * vd), p["wo"].reshape(H * vd, -1))


def route(cfg: dict, router, x):
    """(ids (T, top_k) among the routed experts, weights (T, top_k)):
    the published group-limited greedy top-k of the softmax, ties to the
    lower index."""
    m = cfg["moe"]
    probs = torch.softmax(x @ router.float(), -1)
    T, E = probs.shape
    groups = m.get("n_group", 1)
    if groups > 1:
        best = probs.view(T, groups, -1).amax(-1)
        top = torch.sort(best, dim=-1, descending=True,
                         stable=True).indices[:, :m["topk_group"]]
        keep = torch.zeros_like(best, dtype=torch.bool)
        keep[torch.arange(T, device=x.device)[:, None], top] = True
        probs = probs.masked_fill(~keep.repeat_interleave(E // groups, 1),
                                  0.0)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = order.values[:, :m["top_k"]]
    if m.get("norm_topk", True):
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    else:
        w = w * m.get("routed_scale", 1.0)
    return order.indices[:, :m["top_k"]], w


def moe(cfg: dict, p: dict, x, W: Weights):
    """The held experts' part of the routed result plus the shared
    experts, every assignment computed."""
    m = cfg["moe"]
    ids, w = route(cfg, p["router"], x)
    first = m.get("first_expert", 0)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, j = torch.nonzero(ids == first + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], p["wg"][e], p["wu"][e], p["wd"][e], W)
        y.index_add_(0, tok, out * w[tok, j][:, None])
    if m.get("n_shared"):
        s = p["shared"]
        y = y + swiglu(x, s["wg"], s["wu"], s["wd"], W)
    return y


def block(cfg: dict, kind: str, p: dict, x, pos, W: Weights):
    """One layer over the whole sequence x (L, d); ``p`` as ``products``
    gives it."""
    eps = cfg["norm_eps"]
    x = x + attention(cfg, p["mixer"], rmsnorm(x, p["ln1"]["scale"], eps),
                      pos, W)
    h = rmsnorm(x, p["ln2"]["scale"], eps)
    f = p["ffn"]
    if kind == "dense":
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"], W)
    return x + moe(cfg, f, h, W)


def logits_at(cfg: dict, params: dict, seqs: list, want: list,
              precision: str = "float32") -> list:
    """For each token sequence ``seqs[i]`` (1-D int64 on the device), the
    float32 logits at positions ``want[i]`` after a causal forward,
    shape ``(len(want[i]), padded vocab)``."""
    W = Weights(precision)
    eps = cfg["norm_eps"]
    with exact_float32(), torch.inference_mode():
        tok = params["embed"]["tok"]
        xs = [tok[torch.clamp(s, 0, tok.shape[0] - 1)].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        for i in range(cfg["n_layers"]):
            kind, p = layer(params, cfg, i)
            p = products(p, W)
            for j, x in enumerate(xs):
                xs[j] = block(cfg, kind, p, x, pos[j], W)
            del p
        head = W.w(params["embed"]["head"])
        out = []
        for x, w in zip(xs, want):
            h = rmsnorm(x[w], params["out_norm"]["scale"], eps)
            out.append(W.mm(h, head))
        return out
