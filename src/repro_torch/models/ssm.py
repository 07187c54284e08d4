"""Recurrent blocks of ``repro.models.ssm``: Mamba-2 (SSD), and xLSTM's
mLSTM (matrix memory, chunkwise) and sLSTM (scalar memory, sequential).

``mamba2`` has the reference's two branches: with a state and one token per
lane, the one-step state update; otherwise the chunked scan over the
sequence, zero-padded to a multiple of the chunk, through ``ops.ssd_scan``
(the ssd_scan kernel on the card, its plain version — the reference's
``_ssd_chunked`` — on the CPU).  As in the reference the scan starts from a
zero state whatever state is given; only the conv state carries over.  The
recurrence runs in f32 at every precision; the in/out projections take the
integer path at W8A8/W4A8.

``mlstm`` also has two branches: with a state and one token per lane, the
one-step update of (C, n, m); otherwise the stabilized chunkwise form
(``_mlstm_chunked``) from a zero state, q/k/v and the input gate padded
with 0 and the forget gate with 30.0 to a multiple of the chunk, so that
the final state includes the pad steps, as in the reference.  ``slstm`` is
a loop over t of the block-diagonal recurrence, from the given state or
(h, c, n, m) = (0, 0, 1, 0).  Neither has a Pallas kernel in the reference:
the recurrences are torch ops in f32 at every precision (each
transcendental, reduction and product rounded from f64, so that the card
and the CPU agree bit for bit), and only their projections take the GEMM
kernels.  At W8A8/W4A8 ``w_up`` stays a bf16
linear (no quantization pattern of the reference matches it), its output
``u`` is quantized once for wq, wk, wv and ``w_if`` (bit-equal to the
reference quantizing it four times), the gate branch's SiLU and the inner
``rmsnorm`` stay float, and ``r_w`` and the norm scales stay f32.

The arithmetic is the reference's: ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (and ``jax.nn.log_sigmoid`` its negation at -x) (``torch.nn.functional.softplus`` would return x above
its threshold), ``silu`` is ``x * sigmoid(x)``, the conv sums its taps in
order from ``0 +`` as Python's ``sum`` does, then adds the bias, and the
gated norm runs in f32; the xLSTM blocks keep the -1e30 stabilizer floor,
``max(|den|, exp(-m))`` and k / sqrt(hd) before the products (a product
with the f32 reciprocal, as XLA computes a division by a Python float).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.common import f32, rcp32
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


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise) and sLSTM (scalar memory, loop)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ArchConfig):
    """xLSTM mLSTM block: 2x pre-up-projection (arXiv:2405.04517 Fig. 10)."""
    d_up = 2 * cfg.d_model
    nh = cfg.n_heads
    return d_up, nh, d_up // nh


class MLSTM(nn.Module):
    """w_up and w_gate [d, 2d] (the mLSTM and swish-gate branches), wq, wk
    and wv [2d, 2d], w_if [2d, 2H] (input and forget gate pre-activations,
    interleaved per head), the inner norm's scale [2d] (f32, stays float)
    and wo [2d, d]."""

    def __init__(self, w_up: Linear, w_gate: Linear, wq: Linear, wk: Linear,
                 wv: Linear, w_if: Linear, norm_scale, wo: Linear):
        super().__init__()
        self.w_up, self.w_gate, self.wq, self.wk = w_up, w_gate, wq, wk
        self.wv, self.w_if, self.wo = wv, w_if, wo
        self.norm_scale = nn.Parameter(norm_scale, requires_grad=False)


class SLSTM(nn.Module):
    """w_in [d, 4d] (the i, f, z, o gates' input projections), r_w [H, hd,
    4 hd] (block-diagonal recurrent weights, f32, stays float), the norm's
    scale [d] and wo [d, d]."""

    def __init__(self, w_in: Linear, r_w, norm_scale, wo: Linear):
        super().__init__()
        self.w_in, self.wo = w_in, wo
        self.r_w = nn.Parameter(r_w, requires_grad=False)
        self.norm_scale = nn.Parameter(norm_scale, requires_grad=False)


def init_mlstm_params(gen: torch.Generator, cfg: ArchConfig, device) -> MLSTM:
    d = cfg.d_model
    d_up, nh, hd = _mlstm_dims(cfg)
    return MLSTM(Linear(dense_init(gen, d, d_up, device)),
                 Linear(dense_init(gen, d, d_up, device)),
                 *(Linear(dense_init(gen, d_up, nh * hd, device))
                   for _ in range(3)),
                 Linear(dense_init(gen, d_up, 2 * nh, device)),
                 torch.ones(nh * hd, dtype=F32, device=device),
                 Linear(dense_init(gen, d_up, d, device)))


def init_slstm_params(gen: torch.Generator, cfg: ArchConfig, device) -> SLSTM:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    w_in = Linear(dense_init(gen, d, 4 * d, device))
    r_w = torch.randn((nh, hd, 4 * hd), generator=gen, device=device,
                      dtype=F32) / math.sqrt(hd)
    return SLSTM(w_in, r_w, torch.ones(d, dtype=F32, device=device),
                 Linear(dense_init(gen, d, d, device)))


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> dict:
    """{"C": (B, H, hd, hd) 0, "n": (B, H, hd) 0, "m": (B, H) -1e30}, f32."""
    _, nh, hd = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((batch, nh, hd), dtype=F32, device=device),
            "m": torch.full((batch, nh), -1e30, dtype=F32, device=device)}


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> dict:
    """{"h": 0, "c": 0, "n": 1, "m": 0}, each (B, H, hd) f32."""
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {"h": torch.zeros(shape, dtype=F32, device=device),
            "c": torch.zeros(shape, dtype=F32, device=device),
            "n": torch.ones(shape, dtype=F32, device=device),
            "m": torch.zeros(shape, dtype=F32, device=device)}


# The xLSTM recurrences evaluate each op whose f32 result depends on the
# device (the transcendentals, the reductions and products) in f64 and round
# it to f32 once: a product of f32 values is exact in f64, so the CPU and the
# card then disagree only where an f64 result falls within ~2^-29 of an f32
# rounding boundary, and the card's forward equals the CPU's bit for bit
# (ROADMAP C15).  Elementwise f32 adds, products and divisions are IEEE on
# both devices and stay f32, as does ``_cumsum`` (XLA's order).  Where the
# reference composes a function of several f32 ops (``logaddexp``, the
# logistic as 1 / (1 + exp(-x)), XLA's rational tanh), the port keeps the
# composition and rounds each of its transcendentals or fused multiply-adds
# from f64: a correctly rounded whole drifts further from the reference's
# f32 rounding than the tests' state tolerances allow.

def _f64(fn, *xs):
    """``fn`` of the f64 widening of ``xs``, rounded to f32 once."""
    return fn(*(x.double() for x in xs)).float()


def _exp(x):
    return _f64(torch.exp, x)


# XLA's f32 tanh (Eigen's rational approximation, ``EmitFastTanh``): x
# clamped to +-7.998811..., p(x^2) x / q(x^2) by Horner's rule in fused
# multiply-adds, x itself below |x| = 0.0004.  The rows of _TANH_PQ are the
# Horner steps of p and of q (q's led by zeros: fma(x^2, 0, 0) = 0, so its
# chain starts at its first coefficient exactly), f32 values held in f64.
_TANH_CLAMP = torch.tensor(7.99881172180175781, dtype=F32).item()
_TANH_PQ = torch.tensor(
    [(-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
      5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
      4.89352455891786e-03),
     (0.0, 0.0, 0.0, 1.19825839466702e-06, 1.18534705686654e-04,
      2.26843463243900e-03, 4.89352518554385e-03)],
    dtype=F32).double().T.contiguous()                  # (7 steps, p|q)
_TANH_PQ_ON: dict = {}          # _TANH_PQ per device, copied there once


def xla_tanh(x):
    """XLA's f32 tanh op for op (bit-equal to ``jnp.tanh`` on the CPU over
    1.1M sampled inputs): p and q's Horner chains side by side, each fused
    multiply-add one f64 ``addcmul`` (the product of f32 values is exact,
    so it rounds once, fused or not) rounded to f32."""
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = (xc * xc).double()
    coef = _TANH_PQ_ON.get(x.device)
    if coef is None:
        coef = _TANH_PQ_ON[x.device] = _TANH_PQ.to(x.device)
    coef = coef.view(7, 2, *(1,) * x.dim())
    pq = coef[0].expand(2, *x.shape).float()
    for c in coef[1:]:
        pq = torch.addcmul(c, x2, pq.double()).float()
    return torch.where(x.abs() < 0.0004, x, (xc * pq[0]) / pq[1])


def _sigmoid(x):
    """1 / (1 + exp(-x)), XLA's expansion of the logistic function, the exp
    rounded from f64."""
    return 1.0 / (1.0 + _exp(-x))


def _einsum(eq: str, *xs):
    return _f64(lambda *a: torch.einsum(eq, *a), *xs)


def _sum(x, dim: int):
    return _f64(lambda a: a.sum(dim=dim), x)


def _silu64(x):
    """x * sigmoid(x), the sigmoid rounded from f64."""
    return x * _sigmoid(x)


def _rmsnorm64(x, scale, eps: float):
    """``layers.rmsnorm`` with the mean of squares and the rsqrt rounded
    from f64; x f32 -> f32."""
    var = _f64(lambda a: (a * a).mean(-1, keepdim=True), x)
    return x * _f64(torch.rsqrt, var + eps) * scale


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x), where softplus(a) is
    ``jnp.logaddexp(a, 0)`` = max(a, 0) + log1p(exp(-|a|)), op for op, the
    exp and the log1p rounded from f64."""
    return -(torch.clamp(-x, min=0) + _f64(torch.log1p, _exp(-x.abs())))


def _seq_cumsum(x):
    """Inclusive cumsum over the last dim, one f32 add at a time."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, -1)


def _cumsum(x, dim: int, base: int = 16):
    """``jnp.cumsum`` in the order XLA computes it: past ``base`` values,
    blocks of ``base`` summed in order, then each block offset by the
    (recursive) cumsum of the blocks before it (XLA's reduce-window
    rewrite).  torch's CPU cumsum accumulates in f64, its CUDA cumsum in a
    parallel scan; this order is the same on both and equal to the
    reference's bit for bit."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= base:
        return _seq_cumsum(x).movedim(-1, dim)
    xp = F.pad(x, (0, (-n) % base))
    inner = _seq_cumsum(xp.reshape(*xp.shape[:-1], -1, base))
    before = F.pad(_cumsum(inner[..., -1], -1, base)[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(xp.shape)[..., :n]
    return out.movedim(-1, dim)


def _mlstm_chunked(q, k, v, ig, fg, chunk: int):
    """Stabilized chunkwise mLSTM from a zero state.  q/k/v (B,T,H,D) f32,
    ig/fg raw gate pre-activations (B,T,H); T a multiple of ``chunk``.
    Returns y (B,T,H,D) and the final (C (B,H,D,D), n (B,H,D), m (B,H))."""
    b, t, h, dh = q.shape
    nc = t // chunk
    lf = _log_sigmoid(fg)                                   # log f_t <= 0
    qc = q.reshape(b, nc, chunk, h, dh)
    kc = k.reshape(b, nc, chunk, h, dh) * f32(rcp32(math.sqrt(dh)), q.device)
    vc = v.reshape(b, nc, chunk, h, dh)
    igc = ig.reshape(b, nc, chunk, h)
    bcum = _cumsum(lf.reshape(b, nc, chunk, h), dim=2)      # (B,NC,L,H)
    bsum = bcum[:, :, -1, :]                                 # (B,NC,H)

    # intra-chunk log weights: D[t,s] = bcum_t - bcum_s + ig_s  (s <= t)
    dmat = (bcum[:, :, :, None, :] - bcum[:, :, None, :, :]
            + igc[:, :, None, :, :])                         # (B,NC,L,S,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    dmat = dmat.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    m_intra = dmat.amax(dim=3)                               # (B,NC,L,H)

    # inter-chunk scan of (C, n, m); each chunk reads the state before it
    g_in = bsum[:, :, None, :] - bcum + igc                  # (B,NC,L,H)
    C = torch.zeros((b, h, dh, dh), dtype=F32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=F32, device=q.device)
    m = torch.full((b, h), -1e30, dtype=F32, device=q.device)
    prev = []
    for c in range(nc):
        prev.append((C, n, m))
        g, bs = g_in[:, c], bsum[:, c]
        m_new = torch.maximum(m + bs, g.amax(dim=1))         # (B,H)
        scale_old = _exp(m + bs - m_new)
        w = _exp(g - m_new[:, None, :])                      # (B,L,H)
        wk = w[..., None] * kc[:, c]                         # (B,L,H,D)
        C = (C * scale_old[..., None, None]
             + _einsum("blhd,blhe->bhde", wk, vc[:, c]))
        n = n * scale_old[..., None] + _sum(wk, 1)
        m = m_new
    Cp = torch.stack([p[0] for p in prev], 1)                # (B,NC,H,D,D)
    np_ = torch.stack([p[1] for p in prev], 1)
    mp = torch.stack([p[2] for p in prev], 1)

    # combine intra + inter with a joint stabilizer
    m_inter = bcum + mp[:, :, None, :]                       # (B,NC,L,H)
    m_tot = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)
    w_intra = _exp(dmat - m_tot[:, :, :, None, :])           # (B,NC,L,S,H)
    qkw = _einsum("bclhd,bcshd->bclsh", qc, kc) * w_intra
    num_intra = _einsum("bclsh,bcshe->bclhe", qkw, vc)
    den_intra = _sum(qkw, 3)                                 # (B,NC,L,H)
    w_inter = _exp(m_inter - m_tot)
    qC = _einsum("bclhd,bchde->bclhe", qc, Cp)
    qn = _einsum("bclhd,bchd->bclh", qc, np_)
    num = num_intra + w_inter[..., None] * qC
    den = den_intra + w_inter * qn
    den = torch.maximum(den.abs(), _exp(-m_tot))             # xLSTM denominator
    y = (num / den[..., None]).reshape(b, t, h, dh)
    return y, (C, n, m)


def mlstm(params: MLSTM, x, cfg: ArchConfig, mode: ExecMode,
          state: dict | None = None, chunk: int = 64,
          xq: QRows | None = None):
    """mLSTM block of x (B, T, d).  Returns (out, new_state).  ``xq``: x's
    rows already quantized (the block norm's) for the integer w_gate."""
    b, t, _ = x.shape
    _, nh, hd = _mlstm_dims(cfg)
    if params.w_up.quantized:
        u = apply_linear(x, params.w_up, mode, xq=xq)       # (B,T,2d)
    else:
        # the float w_up (every precision): the bf16 product's f32 sum
        # rounded from f64, so that u does not depend on the device's order
        cd = mode.compute_dtype
        u = _f64(torch.matmul, x.to(cd), params.w_up.weight.to(cd)).to(cd)
    # one quantization of u for the four integer linears that read it
    uq = QRows(*ops.quant_rows(u)) if params.wq.quantized else None

    def proj(p, width):
        return apply_linear(u, p, mode, xq=uq).float().reshape(b, t, nh, width)
    q, k, v = (proj(p, hd) for p in (params.wq, params.wk, params.wv))
    gates = proj(params.w_if, 2)
    ig, fg = gates[..., 0], gates[..., 1]

    if state is not None and t == 1:
        C, n, m = state["C"], state["n"], state["m"]
        lfm = _log_sigmoid(fg[:, 0]) + m                    # (B,H)
        m_new = torch.maximum(lfm, ig[:, 0])
        i_w = _exp(ig[:, 0] - m_new)
        f_w = _exp(lfm - m_new)
        kd = k[:, 0] * f32(rcp32(math.sqrt(hd)), x.device)
        C1 = C * f_w[..., None, None] + (
            (i_w[..., None] * kd)[..., :, None] * v[:, 0, :, None, :])
        n1 = n * f_w[..., None] + i_w[..., None] * kd
        num = _einsum("bhd,bhde->bhe", q[:, 0], C1)
        den = torch.maximum(_sum(q[:, 0] * n1, -1).abs(), _exp(-m_new))
        y = (num / den[..., None])[:, None]                 # (B,1,H,D)
        new_state = {"C": C1, "n": n1, "m": m_new}
    else:
        pad = (-t) % chunk
        if pad:
            q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
            ig = F.pad(ig, (0, 0, 0, pad))
            fg = F.pad(fg, (0, 0, 0, pad), value=30.0)
        y, (C, n, m) = _mlstm_chunked(q, k, v, ig, fg, min(chunk, q.shape[1]))
        y = y[:, :t]
        new_state = {"C": C, "n": n, "m": m}

    g = _silu64(apply_linear(x, params.w_gate, mode, xq=xq).float())
    y = _rmsnorm64(y.reshape(b, t, nh * hd), params.norm_scale,
                   cfg.norm_eps) * g
    out = apply_linear(y.to(x.dtype), params.wo, mode)
    return out, new_state


def slstm(params: SLSTM, x, cfg: ArchConfig, mode: ExecMode,
          state: dict | None = None, xq: QRows | None = None):
    """Scalar-memory xLSTM with recurrent gating: a loop over T.  Returns
    (out, new_state).  ``xq``: x's rows already quantized for w_in."""
    b, t, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    zi = apply_linear(x, params.w_in, mode, xq=xq).float()  # (B,T,4d)
    zi = zi.reshape(b, t, nh, 4 * hd)
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    r_w = params.r_w.double()
    ys = []
    for s in range(t):
        rec = torch.einsum("bhd,hde->bhe", h.double(), r_w).float()
        i_r, f_r, z_r, o_r = torch.split(zi[:, s] + rec, hd, dim=-1)
        fm = f_r + m
        m_new = torch.maximum(fm, i_r)
        i_w, f_w = _exp(torch.stack([i_r - m_new, fm - m_new]))
        c = f_w * c + i_w * xla_tanh(z_r)
        n = f_w * n + i_w
        h = _sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    y = torch.stack(ys, 1).reshape(b, t, d)
    y = _rmsnorm64(y.to(x.dtype).float(), params.norm_scale,
                   cfg.norm_eps).to(x.dtype)
    out = apply_linear(y, params.wo, mode)
    return out, {"h": h, "c": c, "n": n, "m": m}
