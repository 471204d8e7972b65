"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, a sequential recurrence with exponential gating).

Port of ``repro/models/xlstm.py``, with the reference's simplifications:
sLSTM's block-diagonal recurrent matrices are diagonal (per-unit), and
both blocks share the mLSTM pre-up-projection structure (proj_factor
2.0).  The mLSTM runs ``ops.mlstm`` (the chunked form) and
``ops.mlstm_decode``, torch on every device: the reference has no Pallas
kernel for it.  The gate math is f32 as the reference writes it
(``logsigmoid``, the ``m`` stabiliser, ``max(n, 1e-6)``).

Decode states, per slot:
  mLSTM ``{C: (B, nh, dh, dh) f32, n: (B, nh, dh) f32, m: (B, nh) f32,
          conv: (B, conv_kernel-1, d_in) model dtype}``
  sLSTM ``{c, n, m, h: (B, d_in) f32}``
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Leaf
from repro_torch.models.ssm import _causal_conv
from repro_torch.perf import DEFAULT_PERF, PerfConfig

GATES = ("i", "f", "z", "o")


def dims(cfg: ModelConfig):
    x = cfg.xlstm
    d_in = int(x.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    if d_in % nh:
        raise ValueError(f"xLSTM width {d_in} over {nh} heads")
    return x, d_in, nh, d_in // nh


# ===================================================================== mLSTM


def mlstm_leaves(cfg: ModelConfig) -> dict:
    x, d_in, nh, _ = dims(cfg)
    d = cfg.d_model
    return {"up": Leaf((d, 2 * d_in)),
            "conv_w": Leaf((d_in, x.conv_kernel)),
            "conv_b": Leaf((d_in,), "zeros"),
            "wq": Leaf((d_in, d_in)), "wk": Leaf((d_in, d_in)),
            "wv": Leaf((d_in, d_in)),
            "w_i": Leaf((d_in, nh), "small"),
            "b_i": Leaf((nh,), "zeros", f32=True),
            "w_f": Leaf((d_in, nh), "small"),
            "b_f": Leaf((nh,), "ones", f32=True),
            "norm": Leaf((d_in,), "ones"),
            "down": Leaf((d_in, d), "small")}


def _heads(t, nh):
    return t.reshape(*t.shape[:-1], nh, t.shape[-1] // nh)


def _out(cfg, p, y, z):
    """The normed, z-gated output: y (B, S, d_in) -> (B, S, d)."""
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
         * p["norm"].float()).to(z.dtype)
    y = y * F.silu(z.float()).to(z.dtype)
    return y @ p["down"]


def _gates(p, xi):
    return ((xi @ p["w_i"]).float() + p["b_i"],
            (xi @ p["w_f"]).float() + p["b_f"])


def mlstm_forward(cfg: ModelConfig, p, x, *,
                  perf: PerfConfig = DEFAULT_PERF):
    """x: (B, S, d) -> (B, S, d)."""
    xcfg, d_in, nh, _ = dims(cfg)
    xz = x @ p["up"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = F.silu(_causal_conv(p["conv_w"], p["conv_b"], xi).float()
                ).to(xi.dtype)
    q, k, v = (_heads(t @ p[w], nh) for t, w in ((xc, "wq"), (xc, "wk"),
                                                 (xi, "wv")))
    ig, fg = _gates(p, xi)
    y, _ = ops.mlstm(q, k, v, ig, fg, chunk=min(perf.scan_chunk, xcfg.chunk))
    return _out(cfg, p, y.reshape(*x.shape[:2], d_in), z)


def mlstm_state(cfg: ModelConfig, batch: int, device, dtype) -> dict:
    x, d_in, nh, dh = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, nh, dh, dh, **f32),
            "n": torch.zeros(batch, nh, dh, **f32),
            "m": torch.zeros(batch, nh, **f32),
            "conv": torch.zeros(batch, x.conv_kernel - 1, d_in, dtype=dtype,
                                device=device)}


def mlstm_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, d); state {C, n, m, conv}.  Returns (out (B, 1, d), new
    state); the state given is not written."""
    _, d_in, nh, _ = dims(cfg)
    xz = x @ p["up"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = _causal_conv(p["conv_w"], p["conv_b"], xi, init_state=state["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    new_conv = torch.cat([state["conv"][:, 1:], xi.to(state["conv"].dtype)],
                         1)
    q, k, v = (_heads(t @ p[w], nh)[:, 0]
               for t, w in ((xc, "wq"), (xc, "wk"), (xi, "wv")))
    ig, fg = _gates(p, xi[:, 0])
    y, (C, n, m) = ops.mlstm_decode((state["C"], state["n"], state["m"]),
                                    q, k, v, ig, fg)
    out = _out(cfg, p, y.reshape(x.shape[0], 1, d_in), z)
    return out, {"C": C, "n": n, "m": m, "conv": new_conv}


# ===================================================================== sLSTM


def slstm_leaves(cfg: ModelConfig) -> dict:
    _, d_in, _, _ = dims(cfg)
    d = cfg.d_model
    out = {"up": Leaf((d, 2 * d_in)), "norm": Leaf((d_in,), "ones"),
           "down": Leaf((d_in, d), "small")}
    for g in GATES:
        out[f"w_{g}"] = Leaf((d_in, d_in), "small")
        out[f"r_{g}"] = Leaf((d_in,), "small")          # diagonal recurrence
        out[f"b_{g}"] = Leaf((d_in,), "ones" if g == "f" else "zeros",
                             f32=True)
    return out


def _slstm_steps(r, carry, pre):
    """The recurrence over the steps of ``pre`` (4 tensors (T, B, d_in)
    of gate pre-activations) -> (h of each step (T, B, d_in), carry)."""
    c, n, m, h = carry
    hs = []
    for pi, pf, pz, po in zip(*pre):
        it = pi + r["i"] * h
        ft = pf + r["f"] * h
        zt = torch.tanh(pz + r["z"] * h)
        ot = torch.sigmoid(po + r["o"] * h)
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        fd = torch.exp(logf + m - m_new)
        idc = torch.exp(it - m_new)
        c = fd * c + idc * zt
        n = fd * n + idc
        m = m_new
        h = ot * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    return torch.stack(hs), (c, n, m, h)


def _slstm_scan(p, xi, state, *, time_chunk: int = 128):
    """Sequential sLSTM over S.  xi: (B, S, d_in) the gates' source.

    As in the reference, a sequence longer than ``time_chunk`` and a
    multiple of it runs in ``time_chunk`` blocks; when a backward will
    run, each block is under ``torch.utils.checkpoint``, so only the
    block-boundary carries are saved and each block is recomputed in the
    backward."""
    pre = [((xi @ p[f"w_{g}"]).float() + p[f"b_{g}"]).transpose(0, 1)
           for g in GATES]
    r = {g: p[f"r_{g}"].float() for g in GATES}
    S = xi.shape[1]
    if S % time_chunk or S <= time_chunk:
        ys, carry = _slstm_steps(r, state, pre)
        return ys.transpose(0, 1), carry
    blocks, carry = [], state
    for t0 in range(0, S, time_chunk):
        part = [t[t0:t0 + time_chunk] for t in pre]
        if torch.is_grad_enabled():
            ys, carry = checkpoint(_slstm_steps, r, carry, part,
                                   use_reentrant=False)
        else:
            ys, carry = _slstm_steps(r, carry, part)
        blocks.append(ys)
    return torch.cat(blocks).transpose(0, 1), carry


def _slstm_out(cfg, p, ys, z, dtype):
    y = ys.to(dtype)
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
         * p["norm"].float()).to(dtype)
    y = y * F.silu(z.float()).to(dtype)
    return y @ p["down"]


def slstm_forward(cfg: ModelConfig, p, x, *,
                  perf: PerfConfig = DEFAULT_PERF):
    """x: (B, S, d) -> (B, S, d)."""
    _, d_in, _, _ = dims(cfg)
    xz = x @ p["up"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    zeros = torch.zeros(x.shape[0], d_in, dtype=torch.float32,
                        device=x.device)
    ys, _ = _slstm_scan(p, xi, (zeros,) * 4)
    return _slstm_out(cfg, p, ys, z, x.dtype)


def slstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    _, d_in, _, _ = dims(cfg)
    return {k: torch.zeros(batch, d_in, dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}


def slstm_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, d); state {c, n, m, h}.  Returns (out (B, 1, d), new
    state); the state given is not written."""
    _, d_in, _, _ = dims(cfg)
    xz = x @ p["up"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    ys, (c, n, m, h) = _slstm_scan(
        p, xi, (state["c"], state["n"], state["m"], state["h"]))
    return (_slstm_out(cfg, p, ys, z, x.dtype),
            {"c": c, "n": n, "m": m, "h": h})
