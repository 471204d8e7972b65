"""Mamba-2 (SSD) sequence-mixer block, Jamba's non-attention layers
(port of ``repro/models/ssm.py``).

The full-sequence form runs the SSD chunked scan (``ops.ssd``, the
hand-written kernel on the card); decode keeps an O(1) state per layer,
``{conv: (B, d_conv-1, d_in) model dtype, h: (B, nh, dh, N) f32}``.
The casts sit where the reference puts them: the causal conv sums in the
model dtype before its f32 ``silu``, and the gated RMSNorm takes
``y * silu(z)`` back to the model dtype before normalising.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.perf import DEFAULT_PERF, PerfConfig


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    if d_in % s.n_ssm_heads:
        raise ValueError(f"d_inner {d_in} over {s.n_ssm_heads} SSD heads")
    return s, d_in, s.n_ssm_heads, d_in // s.n_ssm_heads


def _causal_conv(w, b, x, *, init_state=None):
    """Depthwise causal conv over S by shifted adds, in x's dtype.
    x: (B, S, d_in); w: (d_in, k); init_state: (B, k-1, d_in) previous
    inputs or None."""
    k = w.shape[1]
    if init_state is None:
        pad = torch.zeros(x.shape[0], k - 1, x.shape[2], dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                  # (B, S+k-1, d_in)
    S = x.shape[1]
    out = xp[:, 0:S] * w[:, 0]
    for j in range(1, k):
        out = out + xp[:, j:j + S] * w[:, j]
    return out + b


def _gated_norm(cfg, p, y, z, dtype):
    y = y * F.silu(z.float()).to(dtype)
    yf = y.float()
    return (yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + cfg.norm_eps)
            * p["norm"].float()).to(dtype)


def _dt_bc(cfg, p, xc):
    s = cfg.ssm
    dt = F.softplus((xc @ p["x_to_dt"]).float() + p["dt_bias"].float())
    bc = xc @ p["x_to_bc"]
    return dt, bc[..., :s.d_state], bc[..., s.d_state:]


def mamba_forward(cfg: ModelConfig, p, x, *,
                  perf: PerfConfig = DEFAULT_PERF):
    """x: (B, S, d) -> (B, S, d)."""
    s, d_in, nh, dh = dims(cfg)
    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = F.silu(_causal_conv(p["conv_w"], p["conv_b"], xi).float()
                ).to(x.dtype)
    dt, Bm, Cm = _dt_bc(cfg, p, xc)
    A = -torch.exp(p["a_log"])
    y, _ = ops.ssd(xc.reshape(*xc.shape[:2], nh, dh), dt, A, Bm, Cm,
                   p["d_skip"], chunk=min(perf.scan_chunk, s.chunk))
    y = _gated_norm(cfg, p, y.reshape(*x.shape[:2], d_in), z, x.dtype)
    return y @ p["out_proj"]


def mamba_decode(cfg: ModelConfig, p, x, state):
    """x: (B, 1, d); state {conv, h}.  Returns (out (B, 1, d), new state);
    the state given is not written."""
    s, d_in, nh, dh = dims(cfg)
    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc = _causal_conv(p["conv_w"], p["conv_b"], xi, init_state=state["conv"])
    xc = F.silu(xc.float()).to(x.dtype)
    new_conv = torch.cat([state["conv"][:, 1:], xi.to(state["conv"].dtype)],
                         1)
    dt, Bm, Cm = _dt_bc(cfg, p, xc)
    A = -torch.exp(p["a_log"])
    y, h_new = ops.ssd_decode(state["h"], xc.reshape(-1, nh, dh), dt[:, 0],
                              A, Bm[:, 0], Cm[:, 0], p["d_skip"])
    y = _gated_norm(cfg, p, y.reshape(x.shape[0], 1, d_in), z, x.dtype)
    return y @ p["out_proj"], {"conv": new_conv,
                               "h": h_new.to(state["h"].dtype)}
