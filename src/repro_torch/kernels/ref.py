"""Plain torch oracles for the port's kernels (``repro/kernels/ref.py``).

Ported: the dense and paged decode-attention oracles, the naive
attention oracle, the blockwise flash forward and two-pass backward that
the CUDA flash kernels are held against, and the SSD (Mamba-2) oracles:
the sequential scan, the chunked scan and the one-token decode step;
and the mLSTM (xLSTM matrix memory) functions: the sequential oracle,
the chunk-parallel form (the reference's "pallas" route too, which is
lax code, not a Pallas kernel) and the one-token decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         scale: Optional[float] = None,
                         block_s: int = 2048):
    """Single-token decode vs a contiguous cache, flash-decoding style —
    the reference's block loop with a running (max, sum, acc).

    q:(B,H,dk) k_cache:(B,Smax,Hkv,dk) v_cache:(B,Smax,Hkv,dv) lengths:(B,)
    Attends to positions < lengths[b].  As in the reference, q (scaled
    in f32) and the probabilities are cast to the cache dtype before
    their products, which accumulate in f32.
    """
    B, Smax, hkv, dk = k_cache.shape
    scale = scale or dk ** -0.5
    H = q.shape[1]
    g = H // hkv
    dv = v_cache.shape[-1]
    bs = min(block_s, Smax)
    if Smax % bs:
        raise ValueError(f"S_max {Smax} is not a multiple of block {bs}")
    qg = (q.reshape(B, hkv, g, dk).float() * scale).to(k_cache.dtype)
    acc = torch.zeros(B, hkv, g, dv, dtype=torch.float32, device=q.device)
    m = torch.full((B, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, hkv, g, dtype=torch.float32, device=q.device)
    for i in range(Smax // bs):
        kb = k_cache[:, i * bs:(i + 1) * bs]
        vb = v_cache[:, i * bs:(i + 1) * bs]
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kb.float())
        pos = i * bs + torch.arange(bs, device=q.device)
        mask = (pos[None] < lengths[:, None])[:, None, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgs,bske->bkge", p.to(v_cache.dtype).float(), vb.float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, dv).to(q.dtype)


def gather_pages(k_pages, v_pages, page_table, lengths):
    """Each slot's pages of a pool (n_pages, page, Hkv, d) as a dense
    cache (B, npp * page, Hkv, d).  Entries of pages that start at or past
    ``lengths[b]`` are never dereferenced (they may hold -1): page 0
    stands in for them, and the length mask hides it."""
    B, npp = page_table.shape
    page = k_pages.shape[1]
    first = torch.arange(npp, device=page_table.device)[None] * page
    tbl = torch.where(first < lengths[:, None], page_table.long(),
                      torch.zeros((), dtype=torch.long,
                                  device=page_table.device))
    return (k_pages[tbl].reshape(B, npp * page, *k_pages.shape[2:]),
            v_pages[tbl].reshape(B, npp * page, *v_pages.shape[2:]))


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               scale: Optional[float] = None,
                               block_s: int = 2048):
    """Paged decode oracle: gathers each sequence's pages, then
    ``decode_attention_ref``.  q:(B,H,dk); k_pages/v_pages:(n_pages, page,
    Hkv, d); page_table:(B, pages_per_seq)."""
    kc, vc = gather_pages(k_pages, v_pages, page_table, lengths)
    return decode_attention_ref(q, kc, vc, lengths, scale=scale,
                                block_s=min(block_s, kc.shape[1]))


# ----------------------------------------------------------- attention


def _expand_kv(q, k):
    """Group-query: q as (B, S, Hkv, G, d)."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} kv heads")
    g = hq // hkv
    return q.reshape(q.shape[0], q.shape[1], hkv, g, q.shape[3]), g


def _acc_dtype(t):
    """f32 arithmetic, as the reference's; f64 inputs (gradcheck) stay
    f64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def attention_naive(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """O(S^2)-memory oracle. q:(B,S,H,dk) k:(B,Sk,Hkv,dk) v:(B,Sk,Hkv,dv).

    Its causal mask is the reference oracle's ``tril(..., Sk - Sq)``; the
    flash forms mask ``qpos >= kpos``.  The two agree when Sq == Sk."""
    scale = scale or q.shape[-1] ** -0.5
    f = _acc_dtype(q)
    qg, _ = _expand_kv(q, k)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f), k.to(f)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bske->bqkge", p, v.to(f))
    return o.reshape(*q.shape[:3], v.shape[-1]).to(q.dtype)


def _causal_hi(iq: int, bq: int, bk: int, sq: int, nk: int) -> int:
    """kv blocks a causal q block needs: those starting at or before its
    last query row (the rest are masked out entirely)."""
    return min(nk, -(-min((iq + 1) * bq, sq) // bk))


def flash_fwd(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None, block_q: int = 512,
              block_k: int = 1024):
    """Blockwise flash forward, step for step the reference's
    ``_flash_fwd``: (out (B,S,H,dv), lse (B,H,S) f32).  The last q and kv
    blocks may be short, so any S works; a causal q block skips the kv
    blocks above its diagonal."""
    B, S, H, dk = q.shape
    Sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale or dk ** -0.5
    f = _acc_dtype(q)
    bq, bk = min(block_q, S), min(block_k, Sk)
    nq, nk = -(-S // bq), -(-Sk // bk)
    qg, g = _expand_kv(q, k)
    dev = q.device
    outs, lses = [], []
    for iq in range(nq):
        qb = qg[:, iq * bq:(iq + 1) * bq].to(f) * scale   # (B,bq,Hkv,G,dk)
        rows = qb.shape[1]
        qpos = iq * bq + torch.arange(rows, device=dev)
        acc = torch.zeros(B, hkv, g, rows, dv, dtype=f, device=dev)
        m = torch.full((B, hkv, g, rows), NEG_INF, dtype=f, device=dev)
        l = torch.zeros(B, hkv, g, rows, dtype=f, device=dev)
        hi = _causal_hi(iq, bq, bk, S, nk) if causal else nk
        for ik in range(hi):
            kb = k[:, ik * bk:(ik + 1) * bk].to(f)
            vb = v[:, ik * bk:(ik + 1) * bk].to(f)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb)
            if causal:
                kpos = ik * bk + torch.arange(kb.shape[1], device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bske->bkgqe", p, vb)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        outs.append((acc / lc[..., None]).permute(0, 3, 1, 2, 4).reshape(
            B, rows, H, dv))
        lses.append(m + torch.log(lc))
    out = torch.cat(outs, dim=1).to(q.dtype)
    lse = torch.cat(lses, dim=-1).reshape(B, H, S)
    return out, lse


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
              scale: Optional[float] = None, block_q: int = 512,
              block_k: int = 1024):
    """Two-pass blockwise backward, step for step the reference's
    ``_flash_bwd``: p is recomputed from ``lse`` (B,H,S); pass 1 gives dq
    per q block, pass 2 dk/dv per kv block summed over the G query heads
    of each kv head.  Returns (dq, dk, dv) in the input dtypes."""
    B, S, H, dkd = q.shape
    Sk, hkv, dvd = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale or dkd ** -0.5
    f = _acc_dtype(q)
    bq, bk = min(block_q, S), min(block_k, Sk)
    nq, nk = -(-S // bq), -(-Sk // bk)
    qg, g = _expand_kv(q, k)
    dev = q.device
    kf, vf = k.to(f), v.to(f)
    lse = lse.to(f).reshape(B, hkv, g, S)
    # D_i = rowsum(dO * O): (B,S,H) -> (B,Hkv,G,S)
    drow = torch.einsum("bshe,bshe->bsh", dout.to(f), out.to(f))
    drow = drow.reshape(B, S, hkv, g).permute(0, 2, 3, 1)
    dog = dout.reshape(B, S, hkv, g, dvd).to(f)

    def mask(s, q0, k0):
        qpos = q0 + torch.arange(s.shape[-2], device=dev)
        kpos = k0 + torch.arange(s.shape[-1], device=dev)
        return torch.where(qpos[:, None] >= kpos[None, :], s,
                           torch.full_like(s, NEG_INF))

    # ---- pass 1: dq per q block (inner loop over kv blocks)
    dqs = []
    for iq in range(nq):
        sl = slice(iq * bq, (iq + 1) * bq)
        qb, dob = qg[:, sl].to(f), dog[:, sl]
        lseb, db = lse[..., sl], drow[..., sl]
        dqa = torch.zeros(*qb.shape[:4], dkd, dtype=f, device=dev)
        hi = _causal_hi(iq, bq, bk, S, nk) if causal else nk
        for ik in range(hi):
            kb, vb = kf[:, ik * bk:(ik + 1) * bk], vf[:, ik * bk:(ik + 1) * bk]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb * scale, kb)
            if causal:
                s = mask(s, iq * bq, ik * bk)
            p = torch.exp(s - lseb[..., None])
            dp = torch.einsum("bqkge,bske->bkgqs", dob, vb)
            ds = p * (dp - db[..., None]) * scale
            dqa = dqa + torch.einsum("bkgqs,bskd->bqkgd", ds, kb)
        dqs.append(dqa.reshape(B, -1, H, dkd))
    dq = torch.cat(dqs, dim=1)

    # ---- pass 2: dk/dv per kv block (inner loop over q blocks)
    dks, dvs = [], []
    for ik in range(nk):
        kb, vb = kf[:, ik * bk:(ik + 1) * bk], vf[:, ik * bk:(ik + 1) * bk]
        dka = torch.zeros(B, kb.shape[1], hkv, dkd, dtype=f, device=dev)
        dva = torch.zeros(B, kb.shape[1], hkv, dvd, dtype=f, device=dev)
        lo = (ik * bk) // bq if causal else 0
        for iq in range(lo, nq):
            sl = slice(iq * bq, (iq + 1) * bq)
            qb, dob = qg[:, sl].to(f), dog[:, sl]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb * scale, kb)
            if causal:
                s = mask(s, iq * bq, ik * bk)
            p = torch.exp(s - lse[..., sl, None])
            dva = dva + torch.einsum("bkgqs,bqkge->bske", p, dob)
            dp = torch.einsum("bqkge,bske->bkgqs", dob, vb)
            ds = p * (dp - drow[..., sl, None]) * scale
            dka = dka + torch.einsum("bkgqs,bqkgd->bskd", ds, qb)
        dks.append(dka)
        dvs.append(dva)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq.to(q.dtype), dk, dv


# ---------------------------------------------------------------- SSD


def ssd_sequential(x, dt, A, B, C, D, *, h0=None):
    """Sequential SSD oracle (a loop over time), the reference's
    ``ssd_sequential``.  x:(b,s,nh,dh) dt:(b,s,nh) A:(nh,) B,C:(b,s,N)
    D:(nh,).  Returns y:(b,s,nh,dh) in x's dtype and h_final:(b,nh,dh,N)
    f32.  h_t = exp(dt*A) h + dt (x_t outer B_t);  y_t = h_t C_t + D x_t."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Af = A.float()
    h = (torch.zeros(b, nh, dh, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None])                 # (b,nh)
        h = h * decay[..., None, None] + (
            dtf[:, t, :, None, None] * xf[:, t, ..., None]
            * Bf[:, t, None, None, :])
        ys.append(torch.einsum("bhdn,bn->bhd", h, Cf[:, t]))
    y = torch.stack(ys, 1) + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), h


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 256, h0=None):
    """Chunked SSD, the reference's ``ssd_chunked``: a loop over chunks
    carrying the (b, nh, dh, N) state, with ``exp((seg_i - seg_j) * A)``
    formed after the cumsum of dt (the Pallas kernel multiplies by A
    before the cumsum; see ``kernels/mamba_scan.py``)."""
    b, s, nh, dh = x.shape
    N = B.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    nc = s // c
    xf = x.float().reshape(b, nc, c, nh, dh)
    dtf = dt.float().reshape(b, nc, c, nh)
    Bf = B.float().reshape(b, nc, c, N)
    Cf = C.float().reshape(b, nc, c, N)
    Af = A.float()
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    h = (torch.zeros(b, nh, dh, N, dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for z in range(nc):
        xz, dtz, Bz, Cz = xf[:, z], dtf[:, z], Bf[:, z], Cf[:, z]
        seg = torch.cumsum(dtz, 1)                             # (b,c,nh)
        tot = seg[:, -1:]
        dec_to_end = torch.exp((tot - seg) * Af)
        dec_from_start = torch.exp(seg * Af)
        y_cross = torch.einsum("bcn,bch,bhdn->bchd", Cz, dec_from_start, h)
        # masked before exp: the upper triangle of rel * A overflows
        rel = (seg[:, :, None, :] - seg[:, None, :, :]) * Af   # (b,i,j,nh)
        decm = torch.exp(torch.where(causal[None, :, :, None], rel,
                                     torch.full_like(rel, -math.inf)))
        cb = torch.einsum("bin,bjn->bij", Cz, Bz)
        m = cb[..., None] * decm * dtz[:, None]
        ys.append(torch.einsum("bijh,bjhd->bihd", m, xz) + y_cross)
        w = dtz * dec_to_end
        states = torch.einsum("bch,bchd,bcn->bhdn", w, xz, Bz)
        h = h * torch.exp(tot[:, 0] * Af)[..., None, None] + states
    y = torch.stack(ys, 1).reshape(b, s, nh, dh)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), h


def ssd_decode_step(h, x, dt, A, B, C, D):
    """One-token SSD update, the reference's ``ssd_decode_step``.
    h:(b,nh,dh,N) x:(b,nh,dh) dt:(b,nh) B,C:(b,N).  Returns (y in x's
    dtype, h_new f32)."""
    hf, xf, dtf = h.float(), x.float(), dt.float()
    decay = torch.exp(dtf * A.float()[None])
    h_new = hf * decay[..., None, None] + (
        dtf[..., None, None] * xf[..., None] * B.float()[:, None, None, :])
    y = torch.einsum("bhdn,bn->bhd", h_new, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), h_new


# ======================================================================
# mLSTM (xLSTM matrix-memory): stabilized chunked linear attention
# ======================================================================


def _mlstm_init(state, b, nh, dh, device):
    if state is None:
        return (torch.zeros(b, nh, dh, dh, dtype=torch.float32, device=device),
                torch.zeros(b, nh, dh, dtype=torch.float32, device=device),
                torch.full((b, nh), -math.inf, dtype=torch.float32,
                           device=device))
    return tuple(t.float() for t in state)


def mlstm_sequential(q, k, v, i_gate, f_gate, *, state=None):
    """Sequential mLSTM oracle (xLSTM eqs. 19-27, log-space stabilized),
    the reference's ``mlstm_sequential``.

    q,k,v:(b,s,nh,dh) gates:(b,s,nh) pre-activation.
    Returns y:(b,s,nh,dh) and final (C:(b,nh,dh,dh), n:(b,nh,dh), m:(b,nh)).
    """
    b, s, nh, dh = q.shape
    qf, kf, vf = q.float(), k.float() / (dh ** 0.5), v.float()
    i_f, f_f = i_gate.float(), f_gate.float()
    C, n, m = _mlstm_init(state, b, nh, dh, q.device)
    ys = []
    for t in range(s):
        qt, kt, vt, it = qf[:, t], kf[:, t], vf[:, t], i_f[:, t]
        logf = F.logsigmoid(f_f[:, t])                      # (b,nh)
        m_new = torch.maximum(logf + m, it)
        fd = torch.exp(logf + m - m_new)
        idc = torch.exp(it - m_new)
        C = fd[..., None, None] * C + idc[..., None, None] * (
            vt[..., None] * kt[..., None, :])
        n = fd[..., None] * n + idc[..., None] * kt
        m = m_new
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m))
        ys.append(num / den[..., None])
    return torch.stack(ys, 1).to(q.dtype), (C, n, m)


def mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk: int = 256, state=None):
    """Chunk-parallel mLSTM matching ``mlstm_sequential``, the
    reference's ``mlstm_chunked``: within a chunk, attention-like with a
    log-decay matrix; across chunks, the carried state applied with
    prefix decays, in a loop over the chunks."""
    b, s, nh, dh = q.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    nc = s // c

    def rs(t):
        return t.float().reshape(b, nc, c, *t.shape[2:])

    qf, kf, vf = rs(q), rs(k) / (dh ** 0.5), rs(v)
    i_f = rs(i_gate)
    lcum = torch.cumsum(F.logsigmoid(rs(f_gate)), 2)      # inclusive
    ltot = lcum[:, :, -1]                                 # (b,nc,nh)
    C, n, m = _mlstm_init(state, b, nh, dh, q.device)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    ys = []
    for z in range(nc):
        qz, kz, vz, iz = qf[:, z], kf[:, z], vf[:, z], i_f[:, z]
        lcz, ltz = lcum[:, z], ltot[:, z]
        # log weights: state decay to position t is lcz_t + m; input j
        # to t is lcz_t - lcz_j + i_j
        a_state = lcz + m[:, None]                        # (b,c,nh)
        a_in = lcz[:, :, None] - lcz[:, None] + iz[:, None]   # (b,t,j,nh)
        a_in = torch.where(causal[None, :, :, None], a_in,
                           torch.full_like(a_in, -math.inf))
        m_t = torch.maximum(a_in.amax(2), a_state)       # running stabilizer
        w_state = torch.exp(a_state - m_t)               # (b,t,nh)
        w_in = torch.exp(a_in - m_t[:, :, None])         # (b,t,j,nh)
        qk = torch.einsum("bthd,bjhd->btjh", qz, kz)
        num = torch.einsum("btjh,btjh,bjhd->bthd", qk, w_in, vz)
        num = num + w_state[..., None] * torch.einsum("bhvk,bthk->bthv", C,
                                                      qz)
        den = torch.einsum("btjh,btjh->bth", qk, w_in) + w_state * \
            torch.einsum("bhk,bthk->bth", n, qz)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state carried to the end of the chunk
        m_new = torch.maximum(ltz + m, (ltz[:, None] - lcz + iz).amax(1))
        w_old = torch.exp(ltz + m - m_new)                # (b,nh)
        w_tok = torch.exp(ltz[:, None] - lcz + iz - m_new[:, None])  # (b,c,nh)
        C = w_old[..., None, None] * C + torch.einsum(
            "bjh,bjhv,bjhk->bhvk", w_tok, vz, kz)
        n = w_old[..., None] * n + torch.einsum("bjh,bjhk->bhk", w_tok, kz)
        m = m_new
    y = torch.stack(ys, 1).reshape(b, s, nh, dh)
    return y.to(q.dtype), (C, n, m)


def mlstm_decode_step(state, q, k, v, i_gate, f_gate):
    """One-token mLSTM update, the reference's ``mlstm_decode_step``.
    state=(C,n,m); q,k,v:(b,nh,dh); gates:(b,nh).  Returns (y in q's
    dtype, (C, n, m) f32)."""
    C, n, m = (t.float() for t in state)
    dh = q.shape[-1]
    qf, kf, vf = q.float(), k.float() / (dh ** 0.5), v.float()
    logf = F.logsigmoid(f_gate.float())
    it = i_gate.float()
    m_new = torch.maximum(logf + m, it)
    fd, idc = torch.exp(logf + m - m_new), torch.exp(it - m_new)
    C = fd[..., None, None] * C + idc[..., None, None] * (
        vf[..., None] * kf[..., None, :])
    n = fd[..., None] * n + idc[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (C, n, m_new)
