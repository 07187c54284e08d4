"""Recurrent blocks: Mamba-2 (SSD), the Mamba-2 half of ``repro.models.ssm``.

``mamba2`` has the reference's two branches: with a state and one token per
lane, the one-step state update; otherwise the chunked scan over the
sequence, zero-padded to a multiple of the chunk, through ``ops.ssd_scan``
(the ssd_scan kernel on the card, its plain version — the reference's
``_ssd_chunked`` — on the CPU).  As in the reference the scan starts from a
zero state whatever state is given; only the conv state carries over.  The
recurrence runs in f32 at every precision; the in/out projections take the
integer path at W8A8/W4A8.  mLSTM and sLSTM are a later slice (ROADMAP.md
§A).

The arithmetic is the reference's: ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` would return x above
its threshold), ``silu`` is ``x * sigmoid(x)``, the conv sums its taps in
order from ``0 +`` as Python's ``sum`` does, then adds the bias, and the
gated norm runs in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ssd_scan import CHUNK
from .config import ArchConfig
from .layers import ExecMode, Linear, QRows, apply_linear, dense_init, rmsnorm

F32 = torch.float32


def _mamba_dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    d_head = 64
    n_heads = cfg.ssm_heads or max(d_inner // d_head, 1)
    d_head = d_inner // n_heads
    return d_inner, n_heads, d_head, cfg.ssm_state


class Mamba2(nn.Module):
    """in_proj [d, 2*d_inner + 2*N + H] (order z, x, B, C, dt), the depthwise
    conv (w [K, 1, C], b [C] over C = d_inner + 2N channels), A_log, D and
    dt_bias [H], the gated norm's scale [d_inner] and out_proj [d_inner, d];
    the vectors are f32 and stay float under PTQ."""

    def __init__(self, in_proj: Linear, out_proj: Linear, conv_w, conv_b,
                 A_log, D, dt_bias, norm_scale):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b),
                        ("A_log", A_log), ("D", D), ("dt_bias", dt_bias),
                        ("norm_scale", norm_scale)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_mamba2_params(gen: torch.Generator, cfg: ArchConfig,
                       device) -> Mamba2:
    d = cfg.d_model
    d_inner, n_heads, _, d_state = _mamba_dims(cfg)
    conv_ch = d_inner + 2 * d_state
    conv_w = torch.randn((cfg.ssm_conv, 1, conv_ch), generator=gen,
                         device=device, dtype=F32) * (1.0 / math.sqrt(cfg.ssm_conv))
    return Mamba2(
        Linear(dense_init(gen, d, 2 * d_inner + 2 * d_state + n_heads, device)),
        Linear(dense_init(gen, d_inner, d, device)), conv_w,
        torch.zeros(conv_ch, dtype=F32, device=device),
        torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=F32, device=device)),
        torch.ones(n_heads, dtype=F32, device=device),
        torch.full((n_heads,), math.log(math.e - 1), dtype=F32, device=device),
        torch.ones(d_inner, dtype=F32, device=device))


def init_mamba2_state(cfg: ArchConfig, batch: int, device) -> dict:
    """{"conv": (B, K-1, C), "ssd": (B, H, N, P)}, f32 zeros."""
    d_inner, nh, hd, ds = _mamba_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * ds),
                                dtype=F32, device=device),
            "ssd": torch.zeros((batch, nh, ds, hd), dtype=F32, device=device)}


def _silu(x):
    return x * torch.sigmoid(x)


def _causal_conv(x, w, b, state):
    """Depthwise causal conv1d.  x (B,T,C), w (K,1,C).  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, T+K-1, C)
    t = x.shape[1]
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + t, :] * w[i, 0]
    y = y + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return _silu(y), new_state


def mamba2(params: Mamba2, x, cfg: ArchConfig, mode: ExecMode,
           state: dict | None = None, chunk: int = CHUNK,
           xq: QRows | None = None):
    """Mamba-2 block of x (B, T, d).  Returns (out, new_state).  ``xq``: x's
    rows already quantized (the fused norm's) for an integer in_proj."""
    b, t, _ = x.shape
    d_inner, n_heads, d_head, d_state = _mamba_dims(cfg)
    zxbcdt = apply_linear(x, params.in_proj, mode, xq=xq).float()
    z, xr, Bm, Cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, d_state, d_state, n_heads], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, params.conv_w, params.conv_b,
        None if state is None else state["conv"])
    xr, Bm, Cm = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    dt = dt + params.dt_bias
    dt = torch.logaddexp(dt, torch.zeros_like(dt))           # softplus, (B,T,H)
    A = -torch.exp(params.A_log)                            # (H,) negative
    xh = xr.reshape(b, t, n_heads, d_head)

    if state is not None and t == 1:
        # decode: one-step state update
        h0 = state["ssd"]                                   # (B,H,N,P)
        da = torch.exp(dt[:, 0] * A)                        # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bm[:, 0], xh[:, 0])
        h1 = h0 * da[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], h1)[:, None]  # (B,1,H,P)
        new_state = {"conv": conv_state, "ssd": h1}
    else:
        pad = (-t) % chunk
        xs, dts, Bs, Cs = xh, dt, Bm, Cm
        if pad:
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dts = F.pad(dt, (0, 0, 0, pad))
            Bs = F.pad(Bm, (0, 0, 0, pad))
            Cs = F.pad(Cm, (0, 0, 0, pad))
        y, final = ops.ssd_scan(xs, dts, A, Bs, Cs, min(chunk, xs.shape[1]))
        y = y[:, :t]
        new_state = {"conv": conv_state, "ssd": final}

    y = y + params.D[None, None, :, None] * xh
    y = y.reshape(b, t, d_inner)
    y = rmsnorm(y * _silu(z), params.norm_scale, cfg.norm_eps)
    out = apply_linear(y.to(x.dtype), params.out_proj, mode)
    return out, new_state
