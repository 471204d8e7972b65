"""Plain float32 reference of a dense GQA decoder (InternLM2's block).

Each layer: RMSNorm, grouped-query attention with rotary positions
(the two halves of a head rotated), a residual add, RMSNorm, a SwiGLU
MLP, a residual add; then a final RMSNorm and the untied output head
over the padded vocabulary.  No cache: each sequence runs whole, causal,
so the logits at position p are those of a decode at p over the tokens
before it.  Layer by layer over all the sequences, so each layer's
weights are made float32 once.

The weights arrive as the benchmark drew them: a tree whose group
leaves are stacked on a leading axis (``groups[pos][...][g]`` is layer
``g * group_size + pos``).  Nothing here imports the program.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (Weights, causal_attention,
                                        exact_float32, rmsnorm, rope, swiglu)


def _layer(params: dict, cfg: dict, i: int) -> dict:
    g, pos = divmod(i, cfg["group_size"])

    def pick(tree):
        return {k: (pick(v) if isinstance(v, dict) else v[g])
                for k, v in tree.items()}
    return pick(params["groups"][pos])


def logits_at(cfg: dict, params: dict, seqs: list, want: list,
              precision: str = "float32") -> list:
    """For each token sequence ``seqs[i]`` (1-D int64 on the device), the
    float32 logits at the positions ``want[i]``, shape
    ``(len(want[i]), padded vocab)``."""
    d, H, hkv = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    eps = cfg["norm_eps"]
    W = Weights(precision)
    with exact_float32(), torch.inference_mode():
        tok = params["embed"]["tok"]
        xs = [tok[torch.clamp(s, 0, tok.shape[0] - 1)].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        for i in range(cfg["n_layers"]):
            p = _layer(params, cfg, i)
            mix, ffn = p["mixer"], p["ffn"]
            wq, wk, wv, wo = (W.w(mix[k]) for k in ("wq", "wk", "wv", "wo"))
            wg, wu, wd = (W.w(ffn[k]) for k in ("w_gate", "w_up", "w_down"))
            for j, x in enumerate(xs):
                h = rmsnorm(x, p["ln1"]["scale"], eps)
                q = W.mm(h, wq).view(-1, H, hd)
                k = W.mm(h, wk).view(-1, hkv, hd)
                v = W.mm(h, wv).view(-1, hkv, hd)
                if cfg.get("rope_theta"):
                    q = rope(q, pos[j], cfg["rope_theta"])
                    k = rope(k, pos[j], cfg["rope_theta"])
                o = causal_attention(q, k, v).reshape(-1, H * hd)
                x = x + W.mm(o, wo)
                h = rmsnorm(x, p["ln2"]["scale"], eps)
                xs[j] = x + swiglu(h, wg, wu, wd, W)
            del wq, wk, wv, wo, wg, wu, wd
        head = W.w(params["embed"]["head"])
        out = []
        for x, w in zip(xs, want):
            h = rmsnorm(x[w], params["out_norm"]["scale"], eps)
            out.append(W.mm(h, head))
        return out
