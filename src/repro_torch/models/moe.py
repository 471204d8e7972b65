"""Mixture-of-experts FFN: routed top-k plus optional shared experts
(port of ``repro/models/moe.py``).

Two dispatches, selected by ``PerfConfig.moe_impl``:

  * ``dense``  — every expert on every token in blocks of tokens, the
    router's gates zeroing the unused results (the comparison the
    reference keeps);
  * ``gather`` — capacity dispatch: assignments ranked per expert in
    token order, those past capacity dropped, the rest gathered into
    (E, cap, d) buffers for batched expert products and combined with
    their gates.

The reference's default, ``a2a`` (all-to-all over an expert-parallel
mesh), resolves to ``gather`` where there is no mesh (``moe.py:246-256``),
as on one card; its ``_a2a_dispatch`` needs more than one card and is not
ported (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.perf import DEFAULT_PERF, PerfConfig

# when a list, ``_gather_dispatch`` appends each call's count of dropped
# assignments (a device scalar, read by the caller after the run)
drop_log: Optional[list] = None


def _router(cfg: ModelConfig, p, xf):
    """xf: (T, d) -> (probs (T,E) f32, top-k ids (T,k), top-k gates (T,k)).
    Ties go to the lower expert index, as ``lax.top_k`` breaks them."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, -1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[:, :cfg.moe.top_k]
    ids = order.indices[:, :cfg.moe.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, ids, gates


def _counts(ids, n_experts: int):
    """Assignments an expert (int64): ``bincount``'s counts, by a scatter
    whose output shape the host knows without reading ``ids`` (the card's
    ``bincount`` reads their maximum back, which waits for the device and
    cannot be captured in a CUDA graph)."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _aux_loss(cfg: ModelConfig, probs, ids):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    E = cfg.moe.n_experts
    fe = _counts(ids, E).float()
    fe = fe / max(ids.numel(), 1)
    pe = probs.mean(0)
    return cfg.moe.aux_coef * E * (fe * pe).sum()


def _swiglu(x, wg, wu, wd):
    """x (T, d) through every expert -> (T, E, d)."""
    g = torch.einsum("td,edf->tef", x, wg)
    u = torch.einsum("td,edf->tef", x, wu)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("tef,efd->ted", h, wd)


def _dense_dispatch(cfg: ModelConfig, p, xf, ids, gates, *,
                    token_block: int):
    """All-experts masked compute, token-blocked to bound peak memory."""
    T = xf.shape[0]
    E = cfg.moe.n_experts
    comb = torch.zeros(T, E, dtype=xf.dtype, device=xf.device)
    rows = torch.arange(T, device=xf.device)[:, None].expand_as(ids)
    comb.index_put_((rows, ids), gates.to(xf.dtype), accumulate=True)
    out = []
    for t0 in range(0, T, token_block):
        yb = _swiglu(xf[t0:t0 + token_block], p["wg"], p["wu"], p["wd"])
        out.append(torch.einsum("ted,te->td", yb, comb[t0:t0 + token_block]))
    return torch.cat(out)


def capacity(cfg: ModelConfig, tokens: int, capacity_factor: float) -> int:
    return max(int(capacity_factor * tokens * cfg.moe.top_k
                   / cfg.moe.n_experts) + 1, 4)


def _gather_dispatch(cfg: ModelConfig, p, xf, ids, gates, *,
                     capacity_factor: float):
    """Capacity-based dispatch: FLOPs scale with top_k, not n_experts.
    An expert keeps its first ``cap`` assignments in token order."""
    T, d = xf.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    Tk = T * k
    cap = capacity(cfg, T, capacity_factor)
    dev = xf.device
    eid = ids.reshape(-1)
    gate = gates.reshape(-1)
    # rank of each assignment within its expert, by a stable sort
    order = torch.sort(eid, stable=True).indices
    counts = _counts(eid, E)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(Tk, device=dev) - starts[eid[order]]
    pos = torch.empty(Tk, dtype=torch.long, device=dev)
    pos[order] = rank_sorted
    keep = pos < cap
    posc = torch.clamp(pos, max=cap - 1)
    if drop_log is not None:
        drop_log.append((~keep).sum())
    # a dropped assignment adds zeros to the last slot, as in the reference
    xrep = xf.repeat_interleave(k, 0)
    contrib = torch.where(keep[:, None], xrep, torch.zeros((), dtype=xf.dtype,
                                                           device=dev))
    buf = torch.zeros(E, cap, d, dtype=xf.dtype, device=dev)
    buf.index_put_((eid, posc), contrib, accumulate=True)
    del xrep, contrib
    g = torch.bmm(buf, p["wg"])
    u = torch.bmm(buf, p["wu"])
    h = F.silu(g.float()).to(xf.dtype)
    del g
    h = h * u
    del u
    yb = torch.bmm(h, p["wd"])                    # (E, cap, d)
    del h
    gathered = (yb[eid, posc] * (gate * keep)[:, None].to(xf.dtype)
                ).reshape(T, k, d)
    # the reference's scatter-add into zeros, in token order, in x's dtype
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]
    return y


def _shared(p, xf):
    s = p["shared"]
    h = F.silu((xf @ s["wg"]).float()).to(xf.dtype) * (xf @ s["wu"])
    return h @ s["wd"]


def moe_forward(cfg: ModelConfig, p, x, *, perf: PerfConfig = DEFAULT_PERF):
    """x: (B, S, d) -> (y (B, S, d), aux loss scalar f32)."""
    B, S, d = x.shape
    impl = "gather" if perf.moe_impl == "a2a" else perf.moe_impl
    xf = x.reshape(-1, d)
    probs, ids, gates = _router(cfg, p, xf)
    if impl == "dense":
        y = _dense_dispatch(cfg, p, xf, ids, gates, token_block=1024)
    elif impl == "gather":
        y = _gather_dispatch(cfg, p, xf, ids, gates,
                             capacity_factor=perf.capacity_factor)
    else:
        raise ValueError(f"unknown moe impl {perf.moe_impl!r}")
    if cfg.moe.n_shared:
        y = y + _shared(p, xf)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, ids)
