"""Plain float32 reference of the Jamba forward (Mamba-2 SSD, attention
without positions, capacity-routed MoE), as the port runs the published
Jamba-v0.1 block.

A group of layers repeats: attention where ``i % attn_period ==
attn_offset``, a Mamba-2 mixer elsewhere; an MoE FFN where ``i %
period == period - 1``, a dense SwiGLU elsewhere.  Each layer adds its
mixer and then its FFN to the residual stream, each behind an RMSNorm.

Mamba-2 mixer: ``in_proj`` to (x, z); a causal depthwise convolution of
x (width ``d_conv``, bias) and SiLU; per-head steps ``dt = softplus(x
W_dt + b)``, shared ``B, C = x W_bc``; the scan

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t

with ``A = -exp(a_log)``, computed chunk by chunk (exact, in float32);
then ``y * silu(z)`` through an RMSNorm and ``out_proj``.

MoE: a float32 router softmax, the two largest probabilities renormed
to gates; each expert keeps its first ``capacity`` assignments in token
order (``capacity = int(factor * T * top_k / E) + 1``, at least 4) and
drops the rest, as the port routes them; the kept tokens go through the
expert's SwiGLU and come back scaled by their gates.

The weights arrive as the benchmark drew them (see ``decoder.py``).
Nothing here imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (Weights, causal_attention,
                                        exact_float32, rmsnorm, swiglu)
from portbench.reference.decoder import _layer

CHUNK = 256


def layer_kinds(cfg: dict) -> list:
    out = []
    for i in range(cfg["group_size"]):
        mixer = ("attn" if i % cfg["attn_period"] == cfg["attn_offset"]
                 else "mamba")
        moe = cfg["moe"]
        ffn = "moe" if i % moe["period"] == moe["period"] - 1 else "dense"
        out.append((mixer, ffn))
    return out


def ssd_scan(x, dt, A, B, C, D, chunk: int = CHUNK):
    """x (L, nh, dh), dt (L, nh), A (nh,), B and C (L, N), D (nh,) ->
    y (L, nh, dh), all float32."""
    L, nh, dh = x.shape
    N = B.shape[1]
    h = torch.zeros(nh, dh, N, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, L, chunk):
        c1 = min(L, c0 + chunk)
        xc, dtc, Bc, Cc = x[c0:c1], dt[c0:c1], B[c0:c1], C[c0:c1]
        cum = torch.cumsum(dtc * A, 0)                        # (c, nh)
        n = c1 - c0
        mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        rel = cum[:, None, :] - cum[None, :, :]               # (i, j, nh)
        dec = torch.exp(rel.masked_fill(~mask[..., None], float("-inf")))
        m = (Cc @ Bc.T)[..., None] * dec * dtc[None]          # (i, j, nh)
        yc = torch.einsum("ijh,jhd->ihd", m, xc)
        yc = yc + torch.einsum("in,hdn->ihd", Cc, h) * torch.exp(cum)[..., None]
        y[c0:c1] = yc + D[None, :, None] * xc
        w = torch.exp(cum[-1:] - cum) * dtc                   # (c, nh)
        h = (h * torch.exp(cum[-1])[:, None, None]
             + torch.einsum("jh,jhd,jn->hdn", w, xc, Bc))
    return y


def mamba(cfg: dict, p: dict, x, W: Weights):
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    nh = s["n_ssm_heads"]
    N = s["d_state"]
    xz = W.mm(x, W.w(p["in_proj"]))
    xi, z = xz[:, :d_in], xz[:, d_in:]
    cw = p["conv_w"].float()                                  # (d_in, k)
    k = cw.shape[1]
    xp = F.pad(xi, (0, 0, k - 1, 0))
    xc = sum(xp[j:j + xi.shape[0]] * cw[:, j] for j in range(k))
    xc = F.silu(xc + p["conv_b"].float())
    dt = F.softplus(W.mm(xc, W.w(p["x_to_dt"])) + p["dt_bias"].float())
    bc = W.mm(xc, W.w(p["x_to_bc"]))
    A = -torch.exp(p["a_log"].float())
    y = ssd_scan(xc.view(-1, nh, d_in // nh), dt, A, bc[:, :N], bc[:, N:],
                 p["d_skip"].float())
    y = y.reshape(-1, d_in) * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg["norm_eps"])
    return W.mm(y, W.w(p["out_proj"]))


def attention(cfg: dict, p: dict, x, W: Weights):
    d, H, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    q = W.mm(x, W.w(p["wq"])).view(-1, H, hd)
    k = W.mm(x, W.w(p["wk"])).view(-1, hkv, hd)
    v = W.mm(x, W.w(p["wv"])).view(-1, hkv, hd)
    o = causal_attention(q, k, v).reshape(-1, H * hd)
    return W.mm(o, W.w(p["wo"]))


def capacity(cfg: dict, tokens: int) -> int:
    m = cfg["moe"]
    return max(int(cfg["perf"]["capacity_factor"] * tokens * m["top_k"]
                   / m["n_experts"]) + 1, 4)


def moe(cfg: dict, p: dict, x, W: Weights):
    m = cfg["moe"]
    E, k = m["n_experts"], m["top_k"]
    T = x.shape[0]
    probs = torch.softmax(x @ p["router"].float(), -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    ids = top.indices[:, :k].reshape(-1)                      # (T k,)
    gate = gates.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    cap = capacity(cfg, T)
    y = torch.zeros_like(x)
    for e in range(E):
        rows = torch.nonzero(ids == e)[:, 0][:cap]            # token order
        if rows.numel() == 0:
            continue
        out = swiglu(x[tok[rows]], W.w(p["wg"][e]), W.w(p["wu"][e]),
                     W.w(p["wd"][e]), W)
        y.index_add_(0, tok[rows], out * gate[rows, None])
    return y


def logits_at(cfg: dict, params: dict, seqs: list, want: list,
              precision: str = "float32") -> list:
    """For each token sequence ``seqs[i]`` (1-D int64 on the device), the
    float32 logits at positions ``want[i]`` after a causal forward."""
    W = Weights(precision)
    eps = cfg["norm_eps"]
    kinds = layer_kinds(cfg)
    out = []
    with exact_float32(), torch.inference_mode():
        tok = params["embed"]["tok"]
        for seq, w in zip(seqs, want):
            x = tok[torch.clamp(seq, 0, tok.shape[0] - 1)].float()
            for i in range(cfg["n_layers"]):
                p = _layer(params, cfg, i)
                mixer, ffn = kinds[i % cfg["group_size"]]
                h = rmsnorm(x, p["ln1"]["scale"], eps)
                x = x + (attention(cfg, p["mixer"], h, W) if mixer == "attn"
                         else mamba(cfg, p["mixer"], h, W))
                h = rmsnorm(x, p["ln2"]["scale"], eps)
                f = p["ffn"]
                x = x + (moe(cfg, f, h, W) if ffn == "moe" else
                         swiglu(h, W.w(f["w_gate"]), W.w(f["w_up"]),
                                W.w(f["w_down"]), W))
            h = rmsnorm(x[w], params["out_norm"]["scale"], eps)
            out.append(W.mm(h, W.w(params["embed"]["head"])))
            del x, h
    return out
