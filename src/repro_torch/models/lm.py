"""Decoder LM: init / forward / lm_loss (port of ``repro.models.lm``).

The reference scans ``lax.scan`` over periods with parameters stacked per
period; the port holds one ``Block`` per layer in an ``nn.ModuleList`` and
runs a Python loop.  ``states`` is a list with one ``{"kv": cache}`` per
layer.  Weights come from an explicit ``torch.Generator`` seeded by the
caller (not jax.random: the numbers differ from the reference's; tests
convert the reference's weights with ``convert.py`` instead).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.common import resolve_device
from .attention import cache_writes
from .blocks import Block, block_forward, init_block_params, init_block_state
from .config import ArchConfig
from .layers import (DEFAULT_DTYPE, ExecMode, Linear, Norm, apply_linear,
                     apply_norm, embed_init, embed_lookup)

F32 = torch.float32


def exec_mode(cfg: ArchConfig) -> ExecMode:
    return ExecMode(precision=cfg.precision, compute_dtype=DEFAULT_DTYPE)


class LM(nn.Module):
    """embed [padded_vocab, d] f32, ``layers`` (one ``Block`` each), the
    final norm and the ``unembed`` head [d, padded_vocab]."""

    def __init__(self, embed: torch.Tensor, layers: list[Block],
                 final_norm: Norm, unembed: Linear):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.unembed = unembed

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> LM:
    """Random weights from ``seed`` on ``device`` — the card unless the
    caller passes device='cpu'."""
    dev = resolve_device(device)
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings are not ported yet "
                                  "(ROADMAP.md §A)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [init_block_params(gen, kind, cfg, dev) for kind in cfg.block_kinds]
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dev)
    unembed = embed_init(gen, cfg.padded_vocab, cfg.d_model, dev).T.contiguous()
    return LM(embed, layers, Norm(cfg.d_model, cfg.norm_type, dev),
              Linear(unembed))


def init_states(cfg: ArchConfig, batch: int, max_seq: int, int8_kv: bool = False,
                dtype=DEFAULT_DTYPE, device=None, paged_pages: int = 0,
                page_size: int = 0) -> list:
    """One ``{"kv": cache}`` per layer (the reference stacks them per
    period).  With ``paged_pages`` > 0 each cache is a paged arena of that
    many ``page_size``-slot pages (``attention.init_paged_cache``), and
    every layer shares ONE page table tensor."""
    dev = resolve_device(device)
    states, pt = [], None
    for kind in cfg.block_kinds:
        st = init_block_state(kind, cfg, batch, max_seq, int8_kv, dtype, dev,
                              paged_pages=paged_pages, page_size=page_size,
                              pt=pt)
        if paged_pages:
            pt = st["kv"]["pt"]
        states.append(st)
    return states


@torch.no_grad()
def forward(params: LM, cfg: ArchConfig, tokens, positions=None,
            states: list | None = None, logits: bool = True):
    """tokens (B, T) int -> (logits (B, T, padded_vocab) f32, states).
    Caches in ``states`` are updated in place."""
    mode = exec_mode(cfg)
    x = embed_lookup(tokens, params.embed, mode.compute_dtype)
    b, t = x.shape[:2]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device).expand(b, t)
    writes = (cache_writes(positions, states[0]["kv"]) if states is not None
              else None)
    new_states = [] if states is not None else None
    for i, (kind, block) in enumerate(zip(cfg.block_kinds, params.layers)):
        st = None if states is None else states[i]
        x, st = block_forward(kind, block, x, cfg, mode, positions, state=st,
                              writes=writes)
        if new_states is not None:
            new_states.append(st)
    x = apply_norm(x, params.final_norm, cfg, mode)
    if not logits:
        return x, new_states
    lg = apply_linear(x, params.unembed, ExecMode(cfg.precision, F32))
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=lg.device) >= cfg.vocab_size
        lg = torch.where(pad, torch.full_like(lg, -1e9), lg)
    return lg, new_states


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@torch.no_grad()
def lm_loss(params: LM, cfg: ArchConfig, tokens, labels):
    """Mean next-token cross entropy of the no-cache forward over the
    positions whose label is >= 0 (a 0-dim f32 tensor)."""
    lg, _ = forward(params, cfg, tokens)
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
