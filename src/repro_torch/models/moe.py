"""Mixture-of-experts FFN: top-k routing with capacity-bounded dispatch, the
MoE layer of ``repro.models.moe`` (``moe.py:85-123``).

The reference's GShard dispatch, step for step: the T tokens in G groups of
``sg`` (``_group_size``, the reference's cost-model table), a capacity of C
slots per expert and group (``core.costmodel.moe_capacity``), an f32 router
and softmax, the top k (ties to the lower expert index, as
``jax.lax.top_k``: a stable descending sort), renormalized by a true
division, each (token, choice) given the next free slot of its expert's
queue in token-major (s, k) order (an integer exclusive cumsum), choices
past capacity dropped; then the experts' gated FFN over (E, G*C, D) rows —
one launch of each expert-batched kernel (``mlp.expert_ffn``) — and the
combine weighted by the renormalized probabilities rounded to bf16.
Qwen2-MoE adds ``sigmoid(x @ shared_gate) * mlp(shared, x)``.

Where the reference multiplies one-hot (G, S, E, C) tensors in einsums, the
port gathers: the dispatch copies each kept token's row into its slot (the
einsum's only nonzero term; empty slots are zero rows), and the combine
sums each token's k weighted expert rows in f32, in choice order, rounding
once to bf16 (an f32 sum of bf16 products, as XLA:CPU computes the bf16
einsum; with k = 2 the order cannot matter).  ``_dispatch_combine`` builds
the reference's dense tensors from the same routing, for the checks.  The
router and the shared gate are f32 products (``torch.matmul``, TF32 off on
the card).  ``moe_aux_loss`` is the reference's Switch load-balancing loss,
held against it by the tests; like the reference's trainer, the port's
trainer adds no aux loss (``repro/train/trainer.py:38-46`` leaves it out).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import costmodel
from ..kernels import autotune
from ..kernels.common import f32, rcp32
from .config import ArchConfig
from .layers import ExecMode, Linear, QRows, dense_init
from .mlp import MLP, expert_ffn, init_mlp_params, mlp

F32 = torch.float32


class MoE(nn.Module):
    """The f32 ``router`` [d, E], the stacked ``experts`` (an ``MLP`` whose
    weights are [E, ...]), and Qwen2-MoE's ``shared`` expert and its
    ``shared_gate`` [d, 1] (None elsewhere)."""

    def __init__(self, router: Linear, experts: MLP,
                 shared: MLP | None = None, shared_gate: Linear | None = None):
        super().__init__()
        self.router, self.experts = router, experts
        self.shared, self.shared_gate = shared, shared_gate


def init_moe_params(gen: torch.Generator, cfg: ArchConfig, device) -> MoE:
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    experts = init_mlp_params(gen, cfg, device, d_ff=ff, experts=e)
    router = Linear(dense_init(gen, d, e, device))
    if not cfg.n_shared_experts:
        return MoE(router, experts)
    shared = init_mlp_params(gen, cfg, device, d_ff=ff * cfg.n_shared_experts)
    return MoE(router, experts, shared, Linear(dense_init(gen, d, 1, device)))


def _group_size(cfg: ArchConfig, t: int) -> int:
    """Tokens per GShard dispatch group (the reference's rule)."""
    ff = cfg.moe_d_ff or cfg.d_ff
    sg = autotune.moe_group_size(t, cfg.d_model, ff, cfg.n_experts,
                                 cfg.n_experts_per_tok, cfg.capacity_factor)
    sg = min(sg, t)
    while t % sg:
        sg //= 2
    return max(sg, 1)


def _route(probs, k: int, capacity: int):
    """probs (G, S, E) f32 -> each (token, choice)'s expert ``idx``, queue
    ``slot`` and ``keep`` (G, S, k), and its renormalized probability
    ``weight`` (G, S, k) f32."""
    g, s, e = probs.shape
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, idx = top.values[..., :k], top.indices[..., :k]
    tot = top_p[..., 0]
    for j in range(1, k):
        tot = tot + top_p[..., j]
    weight = top_p / torch.maximum(tot, f32(1e-9, probs.device))[..., None]
    # the exclusive count of earlier (token, choice) pairs, token-major, that
    # chose the same expert
    flat = idx.reshape(g, s * k)
    onehot = (flat[..., None] == torch.arange(e, device=probs.device)).to(
        torch.int32)                                       # (G, S*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, 2, flat[..., None])[..., 0].reshape(g, s, k)
    return idx, slot, slot < capacity, weight


def _dispatch_combine(probs, k: int, capacity: int):
    """The reference's dense tensors: probs (G, S, E) -> dispatch (G, S, E,
    C) and combine (G, S, E, C) f32."""
    g, s, e = probs.shape
    idx, slot, keep, weight = _route(probs, k, capacity)
    ar_e = torch.arange(e, device=probs.device)
    ar_c = torch.arange(capacity, device=probs.device)
    hit = ((idx[..., None, None] == ar_e[:, None])
           & (slot[..., None, None] == ar_c) & keep[..., None, None])
    disp = hit.any(2).to(F32)                              # (G, S, E, C)
    comb = torch.where(hit, weight[..., None, None],
                       torch.zeros((), dtype=F32, device=probs.device)).sum(2)
    return disp, comb


def moe(params: MoE, x, cfg: ArchConfig, mode: ExecMode,
        xq: QRows | None = None):
    """The MoE FFN of x (B, S, D); ``xq``: x's rows already quantized (the
    fused norm's), read by the shared expert's integer projections."""
    b, s_len, d = x.shape
    t = b * s_len
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    sg = _group_size(cfg, t)
    g = t // sg
    dev = x.device
    xg = x.reshape(g, sg, d)
    capacity = costmodel.moe_capacity(sg, e, k, cfg.capacity_factor)

    logits = xg.float() @ params.router.weight.float()     # f32 router
    probs = torch.softmax(logits, dim=-1)
    idx, slot, keep, weight = _route(probs, k, capacity)

    # dispatch: the token row of every (expert, group, slot), zero rows for
    # the empty slots -> (E, G*C, D)
    n_slots = e * g * capacity
    grp = torch.arange(g, device=dev)[:, None, None]
    dst = torch.where(keep, (idx * g + grp) * capacity + slot, n_slots)
    src = grp * sg + torch.arange(sg, device=dev)[None, :, None]
    table = torch.full((n_slots + 1,), t, dtype=torch.long, device=dev)
    table.scatter_(0, dst.reshape(-1), src.expand_as(dst).reshape(-1))
    rows = torch.cat([x.reshape(t, d), x.new_zeros((1, d))])
    xe = rows[table[:n_slots]].reshape(e, g * capacity, d)

    ye = expert_ffn(params.experts, xe, cfg, mode).reshape(n_slots, d)

    # combine: each token's k expert rows weighted by its bf16-rounded
    # probabilities, summed in f32 in choice order, one rounding to x.dtype
    w = torch.where(keep, weight, torch.zeros((), dtype=F32, device=dev))
    w = w.to(x.dtype).float()
    at = torch.where(keep, dst, 0)
    acc = torch.zeros((g, sg, d), dtype=F32, device=dev)
    for j in range(k):
        acc = acc + w[..., j, None] * ye[at[..., j]].float()
    out = acc.to(x.dtype)

    if params.shared is not None:
        gate = torch.sigmoid(xg.float() @ params.shared_gate.weight.float())
        sq = None if xq is None else QRows(xq.q.reshape(g, sg, d),
                                           xq.scale.reshape(g, sg, 1))
        out = out + gate.to(x.dtype) * mlp(params.shared, xg, cfg, mode,
                                           xq=sq)
    return out.reshape(b, s_len, d)


def moe_aux_loss(params: MoE, x, cfg: ArchConfig) -> torch.Tensor:
    """Switch-style load-balancing loss of x (B, S, d) under the layer's
    router (``repro/models/moe.py:126``): E * sum over experts of (the
    fraction of top-k choices it gets) * (its mean router probability).
    The top k break ties to the lower expert index (C10); the means divide
    by a constant, a product with its f32 reciprocal as jitted (C1)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    xf = x.reshape(b * s, d).to(F32)
    probs = torch.softmax(xf @ params.router.weight.to(F32), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    counts = torch.zeros(e, dtype=F32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=F32,
                                       device=x.device))
    frac = counts * f32(rcp32(b * s * k), x.device)
    imp = probs.sum(0) * f32(rcp32(b * s), x.device)
    return e * torch.sum(frac * imp)
