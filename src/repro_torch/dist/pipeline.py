"""Pipeline parallelism: stage splitting, the GPipe schedule, bubble math.

Port of ``repro.dist.pipeline``.  ``split_stages`` reshapes a layer-stacked
tree (L, ...) into (S, L/S, ...) so each stage owns a contiguous slab of
layers.  ``pipeline_apply`` runs the GPipe schedule over a
``torch.distributed`` group, one process a stage (the rank is the stage):
each step every stage applies its layers to the microbatch in flight and
sends the result to the next rank, so M microbatches drain in M + S - 1
steps; the last stage's outputs are then broadcast, so every rank returns
them, as the reference's psum replicates them.  The group's backend moves
the activations, and nothing falls back to another: NCCL between cards
(rank r on ``cuda:r``), or gloo, on CPU tensors (the tests) or with every
stage on one shared card (NCCL refuses two ranks on one card), where each
send, receive and the broadcast stage the tensor through a host buffer, as
``dist.tp._collective`` does.  ``bubble_fraction`` is the idle share of
that schedule, (S - 1) / (M + S - 1).

The reference's ``shard_map_compat`` papers over ``jax.shard_map``'s API
across jax versions: a JAX program transform with no counterpart here (a
stage is a process, not a shard of one program), so it has no port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def split_stages(params, n_stages: int):
    """Reshape every leaf's leading layer dim L -> (n_stages, L/n_stages)
    (dicts, lists and tuples of tensors)."""
    if isinstance(params, dict):
        return {k: split_stages(v, n_stages) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(split_stages(v, n_stages) for v in params)
    n_layers = params.shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         f"stages")
    return params.reshape(n_stages, n_layers // n_stages, *params.shape[1:])


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def pipeline_apply(layer_fn, stage_params, xs: torch.Tensor, group=None):
    """GPipe over ``group`` (default: the world group), this rank a stage.

    ``layer_fn(w, h) -> h`` applies ONE layer and keeps h's shape;
    ``stage_params`` holds this stage's layers stacked on dim 0; ``xs`` is
    (M, microbatch...), read by stage 0 only.  Returns the (M,
    microbatch...) outputs of the last stage on every rank."""
    group = dist.group.WORLD if group is None else group
    staged = dist.get_backend(group) == "gloo" and xs.device.type == "cuda"
    stage = dist.get_rank(group)
    n_stages = dist.get_world_size(group)
    m = xs.shape[0]
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < n_stages - 1 else None)
    outputs = torch.zeros_like(xs)
    # stage s holds microbatch mb at step s + mb: its recv waits for stage
    # s - 1's send of mb, so the ranks keep the schedule's M + S - 1 steps
    for mb in range(m):
        if prev is None:
            h = xs[mb].clone()
        else:
            h = _recv(torch.empty_like(xs[0]), prev, group, staged)
        for w in stage_params:
            h = layer_fn(w, h)
        if nxt is None:
            outputs[mb] = h
        else:
            h = h.contiguous()
            dist.send(h.cpu() if staged else h, dst=nxt, group=group)
    last = dist.get_global_rank(group, n_stages - 1)
    if not staged:
        dist.broadcast(outputs, src=last, group=group)
        return outputs
    host = outputs.cpu()
    dist.broadcast(host, src=last, group=group)
    return host.to(outputs.device)


def _recv(h: torch.Tensor, src: int, group, staged: bool) -> torch.Tensor:
    """Receive into ``h`` from ``src``; a gloo group takes a card's tensor
    through a host buffer."""
    if not staged:
        dist.recv(h, src=src, group=group)
        return h
    host = torch.empty(h.shape, dtype=h.dtype)
    dist.recv(host, src=src, group=group)
    return host.to(h.device)
