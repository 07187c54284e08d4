"""Block composition: the ``attn``, ``shared_attn`` and ``mamba2`` kinds of
``repro.models.blocks``.  ``attn`` and ``shared_attn`` are pre-norm
self-attention with the skip folded into the out-projection, then pre-norm
MLP; a ``shared_attn`` block's weights are one ``Block`` that every period
reuses (zamba2), with a KV cache per layer.  ``mamba2`` is a pre-norm
Mamba-2 block with its residual add.  The other block kinds are later
slices (ROADMAP.md §A)."""
from __future__ import annotations

import torch
from torch import nn

from .attention import (Attention, attention, init_attn_params, init_cache,
                        init_paged_cache)
from .config import ArchConfig
from .layers import ExecMode, Norm, apply_norm
from .mlp import MLP, init_mlp_params, mlp
from .ssm import Mamba2, init_mamba2_params, init_mamba2_state, mamba2

ATTN_KINDS = ("attn", "shared_attn")
KINDS = ATTN_KINDS + ("mamba2",)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"(ROADMAP.md §A)")


class Block(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, mlp_: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp_


class MambaBlock(nn.Module):
    def __init__(self, norm1: Norm, mamba: Mamba2):
        super().__init__()
        self.norm1, self.mamba = norm1, mamba


def init_block_params(gen: torch.Generator, kind: str, cfg: ArchConfig,
                      device) -> nn.Module:
    _check_kind(kind)
    d, nt = cfg.d_model, cfg.norm_type
    if kind == "mamba2":
        return MambaBlock(Norm(d, nt, device),
                          init_mamba2_params(gen, cfg, device))
    return Block(Norm(d, nt, device), init_attn_params(gen, cfg, device),
                 Norm(d, nt, device), init_mlp_params(gen, cfg, device))


def init_block_state(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                     int8_kv: bool, dtype, device, paged_pages: int = 0,
                     page_size: int = 0, pt=None) -> dict:
    """A mamba2 layer's recurrent state, or an attention layer's KV cache:
    dense, or with ``paged_pages`` > 0 a paged arena of that many
    ``page_size``-slot pages (``serve/kv_pool.py`` owns the page
    bookkeeping) whose page table is ``pt`` when given."""
    _check_kind(kind)
    if kind == "mamba2":
        return init_mamba2_state(cfg, batch, device)
    if paged_pages:
        return {"kv": init_paged_cache(cfg, batch, paged_pages, page_size,
                                       -(-max_seq // page_size), int8=int8_kv,
                                       dtype=dtype, device=device, pt=pt)}
    return {"kv": init_cache(cfg, batch, max_seq, int8=int8_kv, dtype=dtype,
                             device=device)}


def block_forward(kind: str, params: nn.Module, x, cfg: ArchConfig,
                  mode: ExecMode, positions, state: dict | None = None,
                  writes=None, card_order: bool = False):
    _check_kind(kind)
    # each pre-norm hands its output's quantized rows (integer modes) to the
    # integer projections that read it: in_proj; q, k and v; up and gate
    if kind == "mamba2":
        h, hq = apply_norm(x, params.norm1, cfg, mode)
        y, st = mamba2(params.mamba, h, cfg, mode, state=state, xq=hq)
        return x + y, st
    h, hq = apply_norm(x, params.norm1, cfg, mode)
    x, kv = attention(params.attn, h, cfg, mode, positions,
                      cache=None if state is None else state["kv"],
                      residual=x, writes=writes, card_order=card_order, xq=hq)
    new_state = state if state is None else dict(state, kv=kv)
    h, hq = apply_norm(x, params.norm2, cfg, mode)
    x = x + mlp(params.mlp, h, cfg, mode, xq=hq)
    return x, new_state
