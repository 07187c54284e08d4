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
tree's path.

The training rules (port of ``repro.dist.sharding:35-216``): ``AxisEnv``
binds the logical axes dp (batch), fsdp (parameter storage, contraction
dims), tp (Megatron column/row split), ep (experts) and sp (the residual
stream's sequence) to physical mesh axes and their sizes;
``param_specs`` gives each leaf of the reference's tree layout
(``convert.reference_shapes``: the layers stacked over periods) a spec, a
tuple of one entry a dimension (a mesh axis name, a tuple of them, or
None), by the reference's path rules with its divisibility demotion (a
dimension keeps the longest prefix of its axes whose product divides it),
so the specs equal the reference's ``PartitionSpec``s leaf by leaf.
``shard_hint`` is the identity: no path of the port binds a training
mesh, as none of the reference's does (its trainer,
``src/repro/launch/train.py:46``, installs no mesh, so there every hint is
a no-op too); ``launch/specs.py`` and ``launch/dryrun.py`` read the specs
to size a rank's bytes.
"""
from __future__ import annotations

import copy
import dataclasses
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


# ---------------------------------------------------------------------------
# the training rules: logical axes, their binding, parameter specs
# ---------------------------------------------------------------------------

LOGICAL_AXES = ("dp", "fsdp", "tp", "ep", "sp")


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """Binding of logical model axes to physical mesh axes."""

    dp: tuple[str, ...] = ()
    fsdp: tuple[str, ...] = ()
    tp: tuple[str, ...] = ()
    ep: tuple[str, ...] = ()
    sp: tuple[str, ...] = ()
    active: bool = False
    # (mesh_axis_name, size) pairs for every axis of the bound mesh
    sizes: tuple[tuple[str, int], ...] = ()

    def axis_size(self, name: str) -> int:
        return dict(self.sizes).get(name, 1)

    def axes_size(self, axes: tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.axis_size(a)
        return n

    def logical(self, name: str) -> tuple[str, ...]:
        assert name in LOGICAL_AXES, name
        return getattr(self, name)


_ENV: list[AxisEnv] = [AxisEnv()]


def set_axis_env(env: AxisEnv) -> None:
    _ENV[0] = env


def axis_env() -> AxisEnv:
    return _ENV[0]


def _resolve_dim(env: AxisEnv, logical: str | None, dim: int,
                 used: set[str]) -> str | tuple[str, ...] | None:
    """Logical name -> physical mesh axes for one tensor dim: the longest
    PREFIX of the bound axes whose cumulative product divides ``dim``,
    skipping axes already used by an earlier dim of the same spec and axes
    absent from the bound mesh."""
    if logical is None:
        return None
    kept: list[str] = []
    prod = 1
    for ax in env.logical(logical):
        size = env.axis_size(ax)
        if size <= 1 or ax in used:
            continue
        if dim % (prod * size) != 0:
            break
        kept.append(ax)
        prod *= size
    if not kept:
        return None
    used.update(kept)
    return kept[0] if len(kept) == 1 else tuple(kept)


def _resolve_spec(env: AxisEnv, logical: tuple, shape: tuple) -> list:
    used: set[str] = set()
    return [_resolve_dim(env, l, d, used) for l, d in zip(logical, shape)]


def shard_hint(x: torch.Tensor, *logical) -> torch.Tensor:
    """The reference's sharding constraint on an intermediate: the identity
    here, since no port path binds a training mesh (module note)."""
    return x


# row-parallel projections: the CONTRACTION dim carries "tp", the output dim
# fsdp storage
_ROW_PARALLEL = {"wo", "w_out"}
# leaves replicated whatever their divisibility (norm and gate vectors; the
# sLSTM's per-head recurrent weights, read inside the per-step loop)
_REPLICATED = {"scale", "bias", "gate_attn", "gate_mlp", "shared_gate",
               "r_w"}


def _spec_for_path(path: str, shape: tuple) -> tuple:
    """The spec of one leaf of the reference's layout, by its path
    (``periods/0/attn/wq``) and shape: 0/1-D leaves and the replicated
    names none; ``embed`` vocab on tp, d on fsdp; an expert stack's E on
    ep; the row-parallel names tp on dim -2, fsdp on dim -1; every other
    matrix fsdp on dim -2, tp on dim -1 — ep, then tp, then the rest
    resolved first, emitted in dim order."""
    env = _ENV[0]
    name = path.rsplit("/", 1)[-1]
    ndim = len(shape)
    logical: list = [None] * ndim
    if ndim >= 2 and name not in _REPLICATED:
        if name == "embed":
            logical[0], logical[1] = "tp", "fsdp"
        elif name in _ROW_PARALLEL:
            logical[-2], logical[-1] = "tp", "fsdp"
        else:
            logical[-2], logical[-1] = "fsdp", "tp"
        if ("experts/" in path or path.endswith("/experts")) and ndim >= 3:
            logical[ndim - 3] = "ep"
    used: set[str] = set()
    order = sorted(range(ndim),
                   key=lambda i: {"ep": 0, "tp": 1}.get(logical[i], 2))
    out = {i: _resolve_dim(env, logical[i], shape[i], used) for i in order}
    return tuple(out[i] for i in range(ndim))


def map_with_path(tree, fn, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists (a tuple is a
    leaf: a spec, a ``LeafShape``), paths as the reference's
    (``periods/0/attn/wq``); None stays None."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(v, fn, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def param_specs(params, cfg=None):
    """The spec tree of a model's parameters in the reference's layout
    (``convert.reference_shapes(params, cfg)``, any device: a ``meta``
    tree reads no data), one spec a leaf under the bound ``AxisEnv``."""
    from ..convert import reference_shapes
    return map_with_path(reference_shapes(params, cfg),
                          lambda path, leaf: _spec_for_path(path, leaf.shape))
