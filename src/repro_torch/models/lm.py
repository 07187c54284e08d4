"""Decoder LM: init / forward / lm_loss (port of ``repro.models.lm``).

The reference scans ``lax.scan`` over periods with parameters stacked per
period; the port holds one block per layer in an ``nn.ModuleList`` and runs
a Python loop.  A ``shared_attn`` block (zamba2) is one ``Block`` that the
list holds at every position of its kind — the reference's
``params["shared"]``, held once.  ``states`` is a list with one state per
layer: ``{"kv": cache}`` for attention, ``{"conv", "ssd"}`` for mamba2,
``{"C", "n", "m"}`` for mlstm, ``{"h", "c", "n", "m"}`` for slstm, and
``{"xk", "xv"}`` for a cross-attention layer (``xattn``; ``dec`` adds its
``"kv"``), filled once per request by ``precompute_cross_states``.
With tied embeddings (``unembed`` None) the head is the f32 product with
``embed.T``, as in the reference.  Weights come from an explicit
``torch.Generator`` seeded by the caller (not jax.random: the numbers differ
from the reference's; tests convert the reference's weights with
``convert.py`` instead).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.tp import tp_row_shard
from ..kernels.common import generator_device, resolve_device
from .attention import cache_writes, cross_kv_proj
from .blocks import (ATTN_KINDS, CROSS_KINDS, block_forward, init_block_params,
                     init_block_state, unshard_norm)
from .config import ArchConfig
from .layers import (DEFAULT_DTYPE, ExecMode, Linear, Norm, apply_linear,
                     apply_norm, embed_init, embed_lookup, linear)

F32 = torch.float32


def exec_mode(cfg: ArchConfig) -> ExecMode:
    return ExecMode(precision=cfg.precision, compute_dtype=DEFAULT_DTYPE)


class LM(nn.Module):
    """embed [padded_vocab, d] f32, ``layers`` (one block each; a shared
    block appears at each of its positions), the final norm and the
    ``unembed`` head [d, padded_vocab], None with tied embeddings."""

    # (rank, tp) of a serving tensor-parallel shard (dist.sharding)
    tp_shard: tuple[int, int] = (0, 1)

    def __init__(self, embed: torch.Tensor, layers: list[nn.Module],
                 final_norm: Norm, unembed: Linear | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.unembed = unembed

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                precision: str | None = None,
                shard: tuple[int, int] = (0, 1)) -> LM:
    """Random weights from ``seed`` on ``device`` — the card unless the
    caller passes device='cpu'.  With ``precision`` each block is built in
    f32 and quantized for that precision (``quant.ptq.quantize_for``'s
    policy) before the next is built, so the float model never exists
    whole (mixtral-8x7b's is 187 GB in f32); the generator is consumed in
    the same order, so the result equals ``quantize_for`` of the float
    model bit for bit.  ``shard`` (rank, tp): each block is cut to that
    serving tensor-parallel rank's shard before the next is built, the
    result equal to ``dist.shard_params`` of the whole model."""
    from ..dist.sharding import shard_module_
    from ..quant.ptq import quantize_for
    dev = resolve_device(device)
    gen = torch.Generator(device=generator_device(dev)).manual_seed(seed)
    rank, tp = shard

    def build(kind):
        block = init_block_params(gen, kind, cfg, dev)
        if precision is not None:
            block = quantize_for(block, precision)
        if tp > 1:
            shard_module_(block, rank, tp)
        return block
    shared = None
    layers = []
    for kind in cfg.block_kinds:
        if kind == "shared_attn":
            if shared is None:
                shared = build(kind)
            layers.append(shared)
        else:
            layers.append(build(kind))
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dev)
    unembed = (None if cfg.tie_embeddings else Linear(embed_init(
        gen, cfg.padded_vocab, cfg.d_model, dev).T.contiguous()))
    lm = LM(embed, layers, Norm(cfg.d_model, cfg.norm_type, dev), unembed)
    lm = lm if precision is None else quantize_for(lm, precision)
    if tp > 1:
        lm.tp_shard = shard
    return lm


def init_states(cfg: ArchConfig, batch: int, max_seq: int, int8_kv: bool = False,
                dtype=DEFAULT_DTYPE, device=None, paged_pages: int = 0,
                page_size: int = 0, window_slack: int = 0) -> list:
    """One state per layer (the reference stacks them per period): a
    ``{"kv": cache}`` per attention layer — a shared block's too; a
    sliding-window layer's a ring of window + ``window_slack`` slots — and
    a recurrent state at its init values per mamba2, mlstm or slstm layer
    (``blocks.init_block_state``).  With
    ``paged_pages`` > 0 each cache is a paged arena of that many
    ``page_size``-slot pages (``attention.init_paged_cache``), and every
    layer shares ONE page table tensor."""
    dev = resolve_device(device)
    states, pt = [], None
    for kind in cfg.block_kinds:
        st = init_block_state(kind, cfg, batch, max_seq, int8_kv, dtype, dev,
                              paged_pages=paged_pages, page_size=page_size,
                              pt=pt, window_slack=window_slack)
        if paged_pages and kind in ATTN_KINDS:
            pt = st["kv"]["pt"]
        states.append(st)
    return states


def precompute_cross_states(params: LM, cfg: ArchConfig, kv_source,
                            states: list) -> list:
    """Fill each cross layer's static ``xk``/``xv`` (once per request) with
    the K/V projections of ``kv_source`` (B, Sv, d), in the state's dtype:
    decode steps then read them instead of re-projecting the features.
    Returns a new list; the other layers' states pass through."""
    mode = exec_mode(cfg)
    out = []
    for kind, block, st in zip(cfg.block_kinds, params.layers, states):
        if kind in CROSS_KINDS and st is not None:
            xk, xv = cross_kv_proj(block.xattn, kv_source, cfg, mode)
            st = dict(st, xk=xk.to(st["xk"].dtype), xv=xv.to(st["xv"].dtype))
        out.append(st)
    return out


def _first_cache(cfg: ArchConfig, states: list):
    """The KV cache of the first layer that has one (every layer's cache
    takes the same write indices), or None for a model without one."""
    for st in states:
        if st is not None and "kv" in st:
            return st["kv"]
    return None


def _tracks_grad(block: nn.Module, x: torch.Tensor) -> bool:
    return x.requires_grad or any(p.requires_grad for p in block.parameters())


def forward(params: LM, cfg: ArchConfig, tokens, positions=None,
            states: list | None = None, logits: bool = True,
            card_order: bool = False, kv_source=None):
    """tokens (B, T) int -> (logits (B, T, padded_vocab) f32, states).
    Caches in ``states`` are updated in place; recurrent states come back
    new in the returned list.  ``card_order`` (checks only): int8-cache
    attention takes the decode kernels on any device, the card's order
    (``attention.attention``).  ``kv_source`` (B, Sv, d): the vision or
    encoder features the cross layers attend to where ``states`` holds no
    precomputed cross K/V.

    Differentiable: with grad enabled and weights that require grad, the
    no-cache forward builds autograd's graph, and with ``cfg.remat`` each
    layer runs under ``torch.utils.checkpoint`` (non-reentrant): only its
    input is kept, and the backward runs the layer again — the reference's
    ``jax.checkpoint`` over its period body (``nothing_saveable``).  Under
    ``torch.no_grad`` (serving, calibration) nothing changes."""
    mode = exec_mode(cfg)
    x = embed_lookup(tokens, params.embed, mode.compute_dtype)
    b, t = x.shape[:2]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
    # overlap serving TP: the residual stream runs sequence-parallel
    # between boundaries (dist/tp.py); identity elsewhere
    x = tp_row_shard(x)
    cache = None if states is None else _first_cache(cfg, states)
    writes = None if cache is None else cache_writes(positions, cache)
    new_states = [] if states is not None else None
    remat = cfg.remat and states is None and torch.is_grad_enabled()
    for i, (kind, block) in enumerate(zip(cfg.block_kinds, params.layers)):
        st = None if states is None else states[i]
        if remat and _tracks_grad(block, x):
            x, st = checkpoint(block_forward, kind, block, x, cfg, mode,
                               positions, card_order=card_order,
                               kv_source=kv_source, use_reentrant=False)
        else:
            x, st = block_forward(kind, block, x, cfg, mode, positions,
                                  state=st, writes=writes,
                                  card_order=card_order, kv_source=kv_source)
        if new_states is not None:
            new_states.append(st)
    x, xq = unshard_norm(*apply_norm(x, params.final_norm, cfg, mode), b, t)
    if not logits:
        return x, new_states
    if params.unembed is None:
        # tied head: a float f32 product with the embedding table, as the
        # reference's apply_linear on a bare array at compute dtype f32
        lg = linear(x, params.embed.T, None, F32)
    else:
        # an integer head reads the final norm's quantized rows
        lg = apply_linear(x, params.unembed, ExecMode(cfg.precision, F32),
                          xq=xq)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=lg.device) >= cfg.vocab_size
        lg = torch.where(pad, torch.full_like(lg, -1e9), lg)
    return lg, new_states


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(params: LM, cfg: ArchConfig, tokens, labels, kv_source=None):
    """Mean next-token cross entropy of the no-cache forward (cross layers
    attending to ``kv_source``) over the positions whose label is >= 0 (a
    0-dim f32 tensor)."""
    lg, _ = forward(params, cfg, tokens, kv_source=kv_source)
    return xent_loss(lg, labels)


def xent_loss(lg, labels):
    """Cross entropy of logits (B, T, V) against labels (B, T), label < 0
    masked.  The reference picks the gold logit with a one-hot contraction
    (to keep the vocab axis sharded); adding zeros is exact, so the gather
    here gives the same value."""
    lg = lg.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, logz - gold, torch.zeros_like(logz))
    return nll.sum() / mask.sum().clamp(min=1)
