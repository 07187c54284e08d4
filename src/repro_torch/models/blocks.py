"""Block composition: the ``attn``, ``attn_swa``, ``moe``, ``moe_swa``,
``shared_attn`` and ``mamba2`` kinds of ``repro.models.blocks``.  The
attention kinds are pre-norm self-attention with the skip folded into the
out-projection, then a pre-norm MLP (``attn``, ``attn_swa``,
``shared_attn``) or MoE FFN (``moe``, ``moe_swa``); the ``*_swa`` kinds
attend within ``cfg.sliding_window`` over a ring cache of window + slack
slots.  A ``shared_attn`` block's weights are one ``Block`` that every period
reuses (zamba2), with a KV cache per layer.  ``mamba2``, ``mlstm`` and
``slstm`` are a pre-norm recurrent block with its residual add and no MLP
(xlstm's ``d_ff`` is 0).

The cross-attention kinds: ``xattn`` (llama-3.2-vision) is pre-norm
cross-attention, then a pre-norm MLP, each added through the tanh of its f32
gate (``gate_attn``, ``gate_mlp``; zero at init, so the block starts as the
identity); ``dec`` (whisper's decoder) is self-attention with its KV cache,
then cross-attention, then the MLP, three pre-norms, each skip added outside
its out-projection.  Their state holds the cross K/V ``xk``/``xv`` (B, Sv,
Hkv, D), filled once per request (``lm.precompute_cross_states``).  ``enc``
(whisper's encoder) is the ``attn`` block with no state: the reference's
encoder never hands ``causal=False`` on, so it attends causally (ROADMAP
C16).

Under serving tensor parallelism with the overlap boundary (``dist/tp.py``)
the residual stream of the attention kinds is row-sharded: each norm runs
on the rank's rows, and ``tp_row_unshard`` gathers full rows in front of
QKV and MLP-in — the norm's output with its quantized rows and scales, in
one collective (quantization is per row, so the gathered rows are the ones
a tp = 1 norm gives).  Elsewhere it is the identity."""
from __future__ import annotations

import torch
from torch import nn

from ..dist.tp import tp_row_unshard
from .attention import (Attention, attention, init_attn_params, init_cache,
                        init_paged_cache)
from .config import ArchConfig
from .layers import ExecMode, Norm, QRows, apply_norm
from .mlp import MLP, init_mlp_params, mlp
from .moe import MoE, init_moe_params, moe
from .ssm import (MLSTM, SLSTM, Mamba2, init_mamba2_params,
                  init_mamba2_state, init_mlstm_params, init_mlstm_state,
                  init_slstm_params, init_slstm_state, mamba2, mlstm, slstm,
                  xla_tanh)

ATTN_KINDS = ("attn", "attn_swa", "moe", "moe_swa", "shared_attn")
CROSS_KINDS = ("xattn", "dec")
SWA_KINDS = ("attn_swa", "moe_swa")
MOE_KINDS = ("moe", "moe_swa")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not one of the "
                                  f"reference's ({', '.join(KINDS)})")


class Block(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, mlp_: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp_


class MoEBlock(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, moe_: MoE):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.moe = norm1, attn, norm2, moe_


class XAttnBlock(nn.Module):
    def __init__(self, norm1: Norm, xattn: Attention, norm2: Norm, mlp_: MLP,
                 gate_attn: torch.Tensor, gate_mlp: torch.Tensor):
        super().__init__()
        self.norm1, self.xattn, self.norm2, self.mlp = norm1, xattn, norm2, mlp_
        self.gate_attn = nn.Parameter(gate_attn, requires_grad=False)
        self.gate_mlp = nn.Parameter(gate_mlp, requires_grad=False)


class DecBlock(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm,
                 xattn: Attention, norm3: Norm, mlp_: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2 = norm1, attn, norm2
        self.xattn, self.norm3, self.mlp = xattn, norm3, mlp_


class MambaBlock(nn.Module):
    def __init__(self, norm1: Norm, mamba: Mamba2):
        super().__init__()
        self.norm1, self.mamba = norm1, mamba


class MLSTMBlock(nn.Module):
    def __init__(self, norm1: Norm, mlstm_: MLSTM):
        super().__init__()
        self.norm1, self.mlstm = norm1, mlstm_


class SLSTMBlock(nn.Module):
    def __init__(self, norm1: Norm, slstm_: SLSTM):
        super().__init__()
        self.norm1, self.slstm = norm1, slstm_


# the recurrent kinds: (block class, the block's name for its layer, the
# layer's init, its forward, the init of its state)
_RECURRENT = {"mamba2": (MambaBlock, "mamba", init_mamba2_params, mamba2,
                         init_mamba2_state),
              "mlstm": (MLSTMBlock, "mlstm", init_mlstm_params, mlstm,
                        init_mlstm_state),
              "slstm": (SLSTMBlock, "slstm", init_slstm_params, slstm,
                        init_slstm_state)}
KINDS = ATTN_KINDS + CROSS_KINDS + ("enc",) + tuple(_RECURRENT)


def init_block_params(gen: torch.Generator, kind: str, cfg: ArchConfig,
                      device) -> nn.Module:
    _check_kind(kind)
    d, nt = cfg.d_model, cfg.norm_type
    if kind in _RECURRENT:
        block, _, init, _, _ = _RECURRENT[kind]
        return block(Norm(d, nt, device), init(gen, cfg, device))
    if kind in MOE_KINDS:
        return MoEBlock(Norm(d, nt, device), init_attn_params(gen, cfg, device),
                        Norm(d, nt, device), init_moe_params(gen, cfg, device))
    if kind == "xattn":
        gates = [torch.zeros(1, dtype=torch.float32, device=device)
                 for _ in range(2)]
        return XAttnBlock(Norm(d, nt, device),
                          init_attn_params(gen, cfg, device, cross=True),
                          Norm(d, nt, device),
                          init_mlp_params(gen, cfg, device), *gates)
    if kind == "dec":
        return DecBlock(Norm(d, nt, device), init_attn_params(gen, cfg, device),
                        Norm(d, nt, device),
                        init_attn_params(gen, cfg, device, cross=True),
                        Norm(d, nt, device), init_mlp_params(gen, cfg, device))
    return Block(Norm(d, nt, device), init_attn_params(gen, cfg, device),
                 Norm(d, nt, device), init_mlp_params(gen, cfg, device))


def _cross_len(cfg: ArchConfig) -> int:
    return (cfg.n_audio_frames if cfg.is_encoder_decoder
            else cfg.n_vision_tokens)


def init_block_state(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                     int8_kv: bool, dtype, device, paged_pages: int = 0,
                     page_size: int = 0, pt=None,
                     window_slack: int = 0) -> dict | None:
    """None for an ``enc`` layer; a cross layer's zero ``xk``/``xv`` (B, Sv,
    Hkv, D) in ``dtype``, with a ``dec`` layer's dense KV cache beside them;
    a recurrent layer's state (mamba2: conv and SSD; mlstm: C, n, m;
    slstm: h, c, n, m — at their init values), or an attention layer's KV
    cache:
    dense — a ``*_swa`` layer's a ring of ``sliding_window +
    window_slack`` slots (at most ``max_seq``), so that a span's writes
    never evict keys inside the window of its earliest query — or with
    ``paged_pages`` > 0 a paged arena of that many ``page_size``-slot pages
    (``serve/kv_pool.py`` owns the page bookkeeping; window layers use the
    same arena, the engine caps their live pages at the window) whose page
    table is ``pt`` when given."""
    _check_kind(kind)
    if kind == "enc":
        return None
    if kind in CROSS_KINDS:
        shape = (batch, _cross_len(cfg), cfg.n_kv_heads, cfg.head_dim)
        st = {"xk": torch.zeros(shape, dtype=dtype, device=device),
              "xv": torch.zeros(shape, dtype=dtype, device=device)}
        if kind == "dec":
            st["kv"] = init_cache(cfg, batch, max_seq, int8=int8_kv,
                                  dtype=dtype, device=device)
        return st
    if kind in _RECURRENT:
        return _RECURRENT[kind][4](cfg, batch, device)
    if paged_pages:
        return {"kv": init_paged_cache(cfg, batch, paged_pages, page_size,
                                       -(-max_seq // page_size), int8=int8_kv,
                                       dtype=dtype, device=device, pt=pt)}
    window = cfg.sliding_window + window_slack if kind in SWA_KINDS else 0
    return {"kv": init_cache(cfg, batch, max_seq, int8=int8_kv, window=window,
                             dtype=dtype, device=device)}


def unshard_norm(h, hq: QRows | None, b: int, t: int):
    """A norm's rows (and quantized rows) gathered from a row-sharded
    stream into (b, t, ...) (``dist.tp.tp_row_unshard``; identity
    elsewhere)."""
    if hq is None:
        return tp_row_unshard(h, b, t), None
    h, q, s = tp_row_unshard((h, hq.q, hq.scale), b, t)
    return h, QRows(q, s)


def _gate(g, x):
    """tanh of an f32 gate (XLA's tanh), in x's dtype."""
    return xla_tanh(g).to(x.dtype)


def block_forward(kind: str, params: nn.Module, x, cfg: ArchConfig,
                  mode: ExecMode, positions, state: dict | None = None,
                  writes=None, card_order: bool = False, kv_source=None):
    _check_kind(kind)
    # each pre-norm hands its output's quantized rows (integer modes) to the
    # integer projections that read it: in_proj; w_gate; w_in; q, k and v;
    # up and gate
    if kind in _RECURRENT:
        h, hq = apply_norm(x, params.norm1, cfg, mode)
        _, name, _, fwd, _ = _RECURRENT[kind]
        y, st = fwd(getattr(params, name), h, cfg, mode, state=state, xq=hq)
        return x + y, st
    cross_kv = (None if state is None or kind not in CROSS_KINDS
                else (state["xk"], state["xv"]))
    if kind == "xattn":
        h, hq = apply_norm(x, params.norm1, cfg, mode)
        a, _ = attention(params.xattn, h, cfg, mode, positions, xq=hq,
                         kv_source=kv_source, cross_kv=cross_kv)
        x = x + _gate(params.gate_attn, x) * a
        h, hq = apply_norm(x, params.norm2, cfg, mode)
        x = x + _gate(params.gate_mlp, x) * mlp(params.mlp, h, cfg, mode, xq=hq)
        return x, state
    if kind == "dec":
        h, hq = apply_norm(x, params.norm1, cfg, mode)
        a, kv = attention(params.attn, h, cfg, mode, positions,
                          cache=None if state is None else state["kv"],
                          writes=writes, card_order=card_order, xq=hq)
        x = x + a
        new_state = state if state is None else dict(state, kv=kv)
        h, hq = apply_norm(x, params.norm2, cfg, mode)
        a, _ = attention(params.xattn, h, cfg, mode, positions, xq=hq,
                         kv_source=kv_source, cross_kv=cross_kv)
        x = x + a
        h, hq = apply_norm(x, params.norm3, cfg, mode)
        return x + mlp(params.mlp, h, cfg, mode, xq=hq), new_state
    h, hq = unshard_norm(*apply_norm(x, params.norm1, cfg, mode),
                         *positions.shape)
    x, kv = attention(params.attn, h, cfg, mode, positions,
                      cache=None if state is None else state["kv"],
                      window=cfg.sliding_window if kind in SWA_KINDS else 0,
                      residual=x, writes=writes, card_order=card_order, xq=hq)
    new_state = state if state is None else dict(state, kv=kv)
    h, hq = unshard_norm(*apply_norm(x, params.norm2, cfg, mode),
                         *positions.shape)
    if kind in MOE_KINDS:
        return x + moe(params.moe, h, cfg, mode, xq=hq), new_state
    x = x + mlp(params.mlp, h, cfg, mode, xq=hq)
    return x, new_state
