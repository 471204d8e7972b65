"""Mixture-of-experts FFN: routed top-k plus optional shared experts
(port of ``repro/models/moe.py``).

The router ranks ``moe.router_width`` experts (a softmax over all of them,
then greedy top-k, or DeepSeek-V2's group-limited greedy top-k) and this
card holds ``moe.n_experts`` of them from ``moe.first_expert`` on: the
layer computes its held experts' part of the result and adds the shared
experts whole (on one card without the expert-parallel exchange; with
the defaults every expert is held).

Two dispatches, by ``PerfConfig.moe_impl``:

  * ``dense``  — every held expert on every token in blocks of tokens,
    the router's gates zeroing the unused results (the comparison the
    reference keeps).  No assignment is dropped and a token's result
    does not depend on the other tokens; static shapes, no read to the
    host, so a CUDA graph captures it.  The decode step takes it
    (``model.decode_step``): capacity over a step's slots would let one
    session's routing drop another's assignments;
  * ``gather`` — capacity dispatch: assignments ranked per expert in
    token order, those past capacity dropped, the rest gathered into
    (E, cap, d) buffers for batched expert products and combined with
    their gates.

The reference's default, ``a2a`` (all-to-all over an expert-parallel
mesh), resolves to ``gather`` where there is no mesh (``moe.py:246-256``),
as on one card; its ``_a2a_dispatch`` needs more than one card and is not
ported (ROADMAP Queue 1 item 7).

Spans ``moe.route``, ``moe.dispatch`` and ``moe.shared`` (``tracing``);
a caller of the dense dispatch may pass ``counts``, a device tensor whose
first two entries gain the held experts' assignments of the ``live``
tokens and the expert-product rows computed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.perf import DEFAULT_PERF, PerfConfig
from repro_torch.tracing import span

# when a list, ``_gather_dispatch`` appends each call's count of dropped
# assignments (a device scalar, read by the caller after the run)
drop_log: Optional[list] = None


def _router(cfg: ModelConfig, p, xf):
    """xf: (T, d) -> (probs (T, router_width) f32, top-k ids (T,k) among the
    routed experts, top-k gates (T,k)).  Ties go to the lower index, as
    ``lax.top_k`` breaks them.  Group-limited routing keeps, for each
    token, the ``topk_group`` groups with the highest best probability
    and zeroes the other groups' probabilities before the top-k (the
    published ``group_limited_greedy``); the gates are the top-k
    probabilities renormalised, or scaled by ``routed_scale``."""
    m = cfg.moe
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, -1)
    scores = probs
    if m.n_group > 1:
        T = probs.shape[0]
        best = probs.view(T, m.n_group, -1).amax(-1)
        groups = torch.sort(best, dim=-1, descending=True,
                            stable=True).indices[:, :m.topk_group]
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(1, groups,
                                                                True)
        scores = probs.masked_fill(
            ~keep.repeat_interleave(m.router_width // m.n_group, 1), 0.0)
    order = torch.sort(scores, dim=-1, descending=True, stable=True)
    gates = order.values[:, :m.top_k]
    ids = order.indices[:, :m.top_k]
    if m.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:
        gates = gates * m.routed_scale
    return probs, ids, gates


def _held(cfg: ModelConfig, ids):
    """Each assignment's index among the held experts (0 where it is not
    held) and whether this card holds it."""
    local = ids - cfg.moe.first_expert
    held = (local >= 0) & (local < cfg.moe.n_experts)
    return torch.where(held, local, torch.zeros_like(local)), held


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
    """Switch-style load-balance loss: E * sum_e f_e * P_e over the
    router's E experts."""
    E = cfg.moe.router_width
    fe = _counts(ids, E).float()
    fe = fe / max(ids.numel(), 1)
    pe = probs.mean(0)
    return cfg.moe.aux_coef * E * (fe * pe).sum()


def _swiglu(x, wg, wu, wd):
    """x (T, d) through every expert -> (E, T, d): batched products over
    the experts' weights as they lie, x broadcast over them."""
    xe = x.expand(wg.shape[0], *x.shape)
    h = F.silu(torch.bmm(xe, wg).float()).to(x.dtype) * torch.bmm(xe, wu)
    return torch.bmm(h, wd)


def _dense_dispatch(cfg: ModelConfig, p, xf, ids, gates, *,
                    token_block: int, live=None, counts=None):
    """All-experts masked compute, token-blocked to bound peak memory.
    ``counts`` gains [the held assignments of the tokens ``live`` marks
    (all where None), E * T rows]."""
    T = xf.shape[0]
    E = cfg.moe.n_experts
    comb = torch.zeros(T, E, dtype=xf.dtype, device=xf.device)
    rows = torch.arange(T, device=xf.device)[:, None].expand_as(ids)
    eid, held = _held(cfg, ids)
    comb.index_put_((rows, eid), (gates * held).to(xf.dtype),
                    accumulate=True)
    out = []
    for t0 in range(0, T, token_block):
        yb = _swiglu(xf[t0:t0 + token_block], p["wg"], p["wu"], p["wd"])
        out.append(torch.einsum("etd,te->td", yb, comb[t0:t0 + token_block]))
    if counts is not None:
        counts[0] += (held if live is None else held & live[:, None]).sum()
        counts[1] += E * T
    return torch.cat(out)


def capacity(cfg: ModelConfig, tokens: int, capacity_factor: float) -> int:
    """An expert's buffer rows: the factor times its even share of the
    assignments, the router's top_k over its width."""
    return max(int(capacity_factor * tokens * cfg.moe.top_k
                   / cfg.moe.router_width) + 1, 4)


def _gather_dispatch(cfg: ModelConfig, p, xf, ids, gates, *,
                     capacity_factor: float):
    """Capacity-based dispatch: FLOPs scale with top_k, not n_experts.
    A held expert keeps its first ``cap`` assignments in token order;
    assignments to experts not held are ranked apart and dropped."""
    T, d = xf.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    Tk = T * k
    cap = capacity(cfg, T, capacity_factor)
    dev = xf.device
    eid, held = _held(cfg, ids)
    eid, held = eid.reshape(-1), held.reshape(-1)
    gate = gates.reshape(-1)
    # rank of each assignment within its expert (the ones not held in a
    # bucket of their own after the last), by a stable sort
    key = torch.where(held, eid, torch.full_like(eid, E))
    order = torch.sort(key, stable=True).indices
    counts = _counts(key, E + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(Tk, device=dev) - starts[key[order]]
    pos = torch.empty(Tk, dtype=torch.long, device=dev)
    pos[order] = rank_sorted
    keep = (pos < cap) & held
    posc = torch.clamp(pos, max=cap - 1)
    if drop_log is not None:
        drop_log.append((held & ~keep).sum())
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


def moe_forward(cfg: ModelConfig, p, x, *, perf: PerfConfig = DEFAULT_PERF,
                live=None, counts=None):
    """x: (B, S, d) -> (y (B, S, d), aux loss scalar f32).  ``live`` and
    ``counts`` as ``_dense_dispatch`` takes them (the dense dispatch
    only)."""
    B, S, d = x.shape
    impl = "gather" if perf.moe_impl == "a2a" else perf.moe_impl
    xf = x.reshape(-1, d)
    with span("moe.route"):
        probs, ids, gates = _router(cfg, p, xf)
    with span("moe.dispatch"):
        if impl == "dense":
            y = _dense_dispatch(cfg, p, xf, ids, gates, token_block=1024,
                                live=live, counts=counts)
        elif impl == "gather":
            y = _gather_dispatch(cfg, p, xf, ids, gates,
                                 capacity_factor=perf.capacity_factor)
        else:
            raise ValueError(f"unknown moe impl {perf.moe_impl!r}")
    if cfg.moe.n_shared:
        with span("moe.shared"):
            y = y + _shared(p, xf)
    return y.reshape(B, S, d), _aux_loss(cfg, probs, ids)
