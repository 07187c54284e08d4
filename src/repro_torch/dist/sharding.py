"""Serving shard rules: which dimension of each parameter and state leaf a
tensor-parallel rank holds a slice of (``dist/tp.py``).

Port of the serving part of ``repro.dist.sharding`` (``serve_param_specs``,
``serve_state_specs``).  The layout is EXACTNESS-first: only the
column-parallel projections shard — the output dim of ``wq``, ``wk``,
``wv``, ``bq``, ``bk``, ``bv``, ``w_in`` and ``w_gate``, with their PTQ
payloads (``w_q`` [K, N], ``w4`` [K/2, N] packed along K so a split of the
columns never cuts a byte, ``qmul`` [K/g, N], ``scale`` [N]) — and the KV
payloads shard their Hkv axis (dim -2 of ``k``, ``v``, ``k_s``, ``v_s`` and
of the paged ``pk``, ``pv``, ``pks``, ``pvs``).  Everything else is
replicated: ``wo``/``w_out``, the embedding and the head, the norms, and
the page tables and positions (the host scheduler's view, whole on every
rank).  An indivisible dim raises ``TPConfigError``.

A leaf is named as ``named_parameters``/``named_buffers`` name it
(``layers.3.attn.wq.w4``); the rule reads the leaf's name, or its parent
projection's for a weight or payload leaf, as the reference reads its
tree's path.  The training rules (``AxisEnv``, ``shard_hint``,
``param_specs``) are not ported (ROADMAP.md §A10b).
"""
from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

from .tp import TPConfigError

# projections whose OUTPUT dim splits across ranks (heads / d_ff columns)
SERVE_COL_PARALLEL = {"wq", "wk", "wv", "bq", "bk", "bv", "w_in", "w_gate"}
# a Linear's weight and PTQ payload leaves: the rule comes from the parent
# projection's name
_WEIGHT_LEAVES = {"weight", "w_q", "w4", "qmul", "scale"}
# state leaves carrying a KV-head axis at dim -2: dense caches (B, S, Hkv,
# D|1) and paged arenas (n_pages, ps, Hkv, D|1)
SERVE_KV_LEAVES = {"k", "v", "k_s", "v_s", "pk", "pv", "pks", "pvs"}


def serve_param_dim(name: str, shape) -> int | None:
    """The dimension of parameter ``name`` that ranks split (its last), or
    None for a replicated leaf."""
    parts = name.split(".")
    leaf = parts[-1]
    proj = parts[-2] if leaf in _WEIGHT_LEAVES and len(parts) >= 2 else leaf
    if proj not in SERVE_COL_PARALLEL or len(shape) == 0:
        return None
    return len(shape) - 1


def serve_state_dim(name: str, shape) -> int | None:
    """The dimension of state leaf ``name`` that ranks split (its Hkv axis,
    -2 as a positive index), or None for a replicated leaf."""
    if name not in SERVE_KV_LEAVES or len(shape) < 2:
        return None
    return len(shape) - 2


def _slice(t: torch.Tensor, dim: int, rank: int, tp: int, what: str):
    n = t.shape[dim]
    if n % tp:
        raise TPConfigError(f"serving TP cannot shard {what}: dim {dim} of "
                            f"{tuple(t.shape)} is {n}, % tp={tp} != 0")
    # a copy of its own, so the full tensor can be freed
    return t.narrow(dim, rank * (n // tp), n // tp).clone(
        memory_format=torch.contiguous_format)


def shard_module_(module: nn.Module, rank: int, tp: int) -> None:
    """Slice ``module``'s column-parallel leaves down to rank ``rank`` of
    ``tp``, IN PLACE (a module shared at several positions is sliced
    once)."""
    for mname, mod in module.named_modules():
        leaves = itertools.chain(mod.named_parameters(recurse=False),
                                 mod.named_buffers(recurse=False))
        for lname, t in list(leaves):
            full = f"{mname}.{lname}" if mname else lname
            dim = serve_param_dim(full, t.shape)
            if dim is None:
                continue
            piece = _slice(t.detach(), dim, rank, tp, full)
            if lname in mod._parameters:
                piece = nn.Parameter(piece, requires_grad=t.requires_grad)
            setattr(mod, lname, piece)


def shard_params(lm: nn.Module, rank: int, tp: int) -> nn.Module:
    """Rank ``rank``'s shard of a converted or initialized model: a new
    module tree whose column-parallel leaves are slices and whose
    replicated leaves are ``lm``'s own tensors (``lm`` is unchanged).  The
    result carries ``tp_shard = (rank, tp)``, which the engine checks."""
    if tp == 1:
        return lm
    memo = {id(t): t for t in itertools.chain(lm.parameters(), lm.buffers())}
    out = copy.deepcopy(lm, memo)
    shard_module_(out, rank, tp)
    out.tp_shard = (rank, tp)
    return out


def shard_states(states: list, rank: int, tp: int) -> list:
    """Rank ``rank``'s shard of a serving state list (``init_states``): each
    KV payload sliced on its Hkv axis; positions and the page table every
    layer shares pass through (the same tensors)."""
    if tp == 1:
        return states
    out = []
    for st in states:
        if st is None or "kv" not in st:
            out.append(st)
            continue
        kv = {k: v if serve_state_dim(k, v.shape) is None
              else _slice(v, serve_state_dim(k, v.shape), rank, tp, k)
              for k, v in st["kv"].items()}
        out.append(dict(st, kv=kv))
    return out
