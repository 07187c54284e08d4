"""Convert the JAX reference's parameter tree (as numpy) into the port's
modules, and back.

``from_reference`` takes ``jax.device_get(params)`` of
``repro.models.init_params`` (optionally after ``ptq_quantize_params``): a
dict with ``embed``, ``final_norm``, ``periods`` (one entry per position of
the block pattern, each leaf stacked over the ``n_periods`` repetitions;
None at a ``shared_attn`` position), ``shared`` (the one ``shared_attn``
block, unstacked) and ``unembed`` (absent with tied embeddings).  It
unstacks them into one block per layer — the shared block built once and
placed at each of its positions — and carries float leaves, the ``{w_q,
scale}`` and ``{w4, qmul, scale}`` PTQ dicts, the gated MLP's ``w_gate``,
the Mamba-2 vectors and the f32 embed/unembed over unchanged.  A MoE block
(``moe``, ``moe_swa``) keeps the reference's layout under ``moe``:
``router/w`` [d, E], ``experts/{w_in, w_gate, w_out}`` stacked over E (each
a float array or a PTQ dict of stacked leaves), and Qwen2-MoE's ``shared``
MLP and ``shared_gate`` [d, 1].  An xLSTM block keeps the reference's
``mlstm/{w_up, w_gate, wq, wk, wv, w_if, norm_scale, wo}`` or
``slstm/{w_in, r_w, norm_scale, wo}`` (``w_up``, ``r_w`` and the norm
scales float at every precision).  A cross-attention block keeps
``xattn/{wq, wk, wv, wo}`` beside its norms and MLP: ``xattn`` with the f32
gates ``gate_attn`` and ``gate_mlp`` (1,), ``dec`` with ``attn`` and
``norm3`` too.  An encoder-decoder tree (``repro.models.init_encdec_params``)
is ``{"encoder": {"pos_embed", "layers" (the ``enc`` blocks stacked over
``n_encoder_layers``), "final_norm"}, "decoder": <the decoder LM's tree>}``
and converts to an ``EncDec``.
``to_reference`` is its inverse (the same numpy tree layout), so a round
trip reproduces the tree exactly; ``reference_shapes`` gives that layout's
shapes and dtypes without reading data (a ``meta`` tree too).  ``tree_to_reference`` carries any
per-parameter tensors (gradients, AdamW moments), keyed by
``named_parameters`` names, into the same layout.

This module speaks numpy and torch only; the tests hand it the reference's
arrays.
"""
from __future__ import annotations

import copy
from typing import Callable, NamedTuple

import numpy as np
import torch

from .kernels.common import resolve_device
from .models.attention import Attention
from .models.blocks import (Block, DecBlock, MambaBlock, MLSTMBlock, MoEBlock,
                            SLSTMBlock, XAttnBlock)
from .models.config import ArchConfig
from .models.encdec import EncDec, Encoder
from .models.layers import Linear, Norm
from .models.lm import LM
from .models.mlp import MLP
from .models.moe import MoE
from .models.ssm import MLSTM, SLSTM, Mamba2

_MAMBA_VECTORS = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale")
# an xLSTM layer's leaves in the reference's order: (linears, float tensors)
_XLSTM = {"mlstm": (MLSTMBlock, MLSTM, ("w_up", "w_gate", "wq", "wk", "wv",
                                        "w_if", "norm_scale", "wo"),
                    ("norm_scale",)),
          "slstm": (SLSTMBlock, SLSTM, ("w_in", "r_w", "norm_scale", "wo"),
                    ("r_w", "norm_scale"))}
_KINDS = ("attn", "attn_swa", "moe", "moe_swa", "shared_attn", "mamba2",
          "mlstm", "slstm", "xattn", "dec")


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _pick(i):
    """Layer ``i`` of a stacked leaf (i=None: unstacked)."""
    return (lambda a: a) if i is None else (lambda a: a[i])


def _linear(leaf, i, dev) -> Linear:
    pick = _pick(i)
    if isinstance(leaf, dict):
        return Linear(**{k: _t(pick(v), dev) for k, v in leaf.items()})
    return Linear(_t(pick(leaf), dev))


def _norm(leaf, i, d, norm_type, dev) -> Norm:
    n = Norm(d, norm_type, dev)
    pick = _pick(i)
    n.scale.copy_(_t(pick(leaf["scale"]), dev))
    if n.bias is not None:
        n.bias.copy_(_t(pick(leaf["bias"]), dev))
    return n


def _mlp(m: dict, i, dev) -> MLP:
    return MLP(_linear(m["w_in"], i, dev), _linear(m["w_out"], i, dev),
               _linear(m["w_gate"], i, dev) if "w_gate" in m else None)


def _attn(a: dict, i, dev) -> Attention:
    pick = _pick(i)
    bias = {k: (_t(pick(a[k]), dev) if k in a else None)
            for k in ("bq", "bk", "bv")}
    return Attention(_linear(a["wq"], i, dev), _linear(a["wk"], i, dev),
                     _linear(a["wv"], i, dev), _linear(a["wo"], i, dev),
                     **bias)


def _cross_block(kind: str, per: dict, i, cfg: ArchConfig,
                 dev) -> XAttnBlock | DecBlock:
    d, nt = cfg.d_model, cfg.norm_type
    norms = [_norm(per[k], i, d, nt, dev)
             for k in ("norm1", "norm2", "norm3") if k in per]
    if kind == "xattn":
        pick = _pick(i)
        return XAttnBlock(norms[0], _attn(per["xattn"], i, dev), norms[1],
                          _mlp(per["mlp"], i, dev),
                          *(_t(pick(per[k]), dev)
                            for k in ("gate_attn", "gate_mlp")))
    return DecBlock(norms[0], _attn(per["attn"], i, dev), norms[1],
                    _attn(per["xattn"], i, dev), norms[2],
                    _mlp(per["mlp"], i, dev))


def _attn_block(per: dict, i, cfg: ArchConfig, dev) -> Block | MoEBlock:
    d, nt = cfg.d_model, cfg.norm_type
    attn = _attn(per["attn"], i, dev)
    norm1 = _norm(per["norm1"], i, d, nt, dev)
    norm2 = _norm(per["norm2"], i, d, nt, dev)
    if "moe" not in per:
        return Block(norm1, attn, norm2, _mlp(per["mlp"], i, dev))
    m = per["moe"]
    shared = (_mlp(m["shared"], i, dev), _linear(m["shared_gate"], i, dev)
              ) if "shared" in m else (None, None)
    return MoEBlock(norm1, attn, norm2,
                    MoE(_linear(m["router"]["w"], i, dev),
                        _mlp(m["experts"], i, dev), *shared))


def _mamba_block(per: dict, i, cfg: ArchConfig, dev) -> MambaBlock:
    m = per["mamba"]
    pick = _pick(i)
    return MambaBlock(
        _norm(per["norm1"], i, cfg.d_model, cfg.norm_type, dev),
        Mamba2(_linear(m["in_proj"], i, dev), _linear(m["out_proj"], i, dev),
               *(_t(pick(m[k]), dev) for k in _MAMBA_VECTORS)))


def _xlstm_block(kind: str, per: dict, i, cfg: ArchConfig,
                 dev) -> MLSTMBlock | SLSTMBlock:
    block, layer, leaves, floats = _XLSTM[kind]
    x, pick = per[kind], _pick(i)
    return block(_norm(per["norm1"], i, cfg.d_model, cfg.norm_type, dev),
                 layer(*(_t(pick(x[k]), dev) if k in floats
                         else _linear(x[k], i, dev) for k in leaves)))


def from_reference(tree: dict, cfg: ArchConfig, device=None) -> LM | EncDec:
    """numpy parameter tree of the reference -> ``LM`` (an ``EncDec`` for
    an encoder-decoder tree) on ``device`` (the card unless
    device='cpu')."""
    dev = resolve_device(device)
    if "encoder" in tree:
        enc = tree["encoder"]
        layers = [_attn_block(enc["layers"], i, cfg, dev)
                  for i in range(cfg.n_encoder_layers)]
        return EncDec(Encoder(_t(enc["pos_embed"], dev), layers,
                              _norm(enc["final_norm"], None, cfg.d_model,
                                    cfg.norm_type, dev)),
                      from_reference(tree["decoder"], cfg, dev))
    if not set(cfg.block_pattern) <= set(_KINDS):
        raise NotImplementedError(f"block pattern {cfg.block_pattern}: the "
                                  f"port converts {_KINDS}")
    shared = (_attn_block(tree["shared"], None, cfg, dev)
              if "shared_attn" in cfg.block_pattern else None)
    layers = []
    for i, kind in enumerate(cfg.block_kinds):
        rep, pos = divmod(i, cfg.period)
        if kind == "shared_attn":
            layers.append(shared)
        elif kind == "mamba2":
            layers.append(_mamba_block(tree["periods"][pos], rep, cfg, dev))
        elif kind in _XLSTM:
            layers.append(_xlstm_block(kind, tree["periods"][pos], rep, cfg,
                                       dev))
        elif kind in ("xattn", "dec"):
            layers.append(_cross_block(kind, tree["periods"][pos], rep, cfg,
                                       dev))
        else:
            layers.append(_attn_block(tree["periods"][pos], rep, cfg, dev))
    return LM(_t(tree["embed"], dev), layers,
              _norm(tree["final_norm"], None, cfg.d_model, cfg.norm_type, dev),
              _linear(tree["unembed"], None, dev) if "unembed" in tree else None)


class LeafShape(NamedTuple):
    """A leaf of ``reference_shapes``' tree: its shape and dtype."""
    shape: tuple
    dtype: torch.dtype


class _Leaves(NamedTuple):
    """How ``_reference_tree`` turns tensors into leaves (``arr``) and
    stacks a list of leaves over layers (``stack``)."""
    arr: Callable
    stack: Callable


_NUMPY = _Leaves(lambda t: t.detach().cpu().numpy(), np.stack)
_SHAPES = _Leaves(lambda t: LeafShape(tuple(t.shape), t.dtype),
                  lambda xs: LeafShape((len(xs),) + xs[0].shape, xs[0].dtype))


def _leaf(lin: Linear, io: _Leaves):
    if lin.int4:
        return {k: io.arr(getattr(lin, k)) for k in ("w4", "qmul", "scale")}
    if lin.quantized:
        return {"w_q": io.arr(lin.w_q), "scale": io.arr(lin.scale)}
    return io.arr(lin.weight)


def _stacker(io: _Leaves):
    def stack(leaves: list):
        if isinstance(leaves[0], dict):
            return {k: io.stack([x[k] for x in leaves]) for k in leaves[0]}
        return io.stack(leaves)
    return stack


def _norm_leaf(n: Norm, io: _Leaves) -> dict:
    out = {"scale": io.arr(n.scale)}
    if n.bias is not None:
        out["bias"] = io.arr(n.bias)
    return out


def _mlp_tree(mlps: list[MLP], stack, io: _Leaves) -> dict:
    return {k: stack([_leaf(getattr(m, k), io) for m in mlps])
            for k in ("w_in", "w_out", "w_gate")
            if getattr(mlps[0], k) is not None}


def _attn_leaves(attns: list[Attention], stack, io: _Leaves) -> dict:
    attn = {k: stack([_leaf(getattr(a, k), io) for a in attns])
            for k in ("wq", "wk", "wv", "wo")}
    for k in ("bq", "bk", "bv"):
        if getattr(attns[0], k) is not None:
            attn[k] = stack([io.arr(getattr(a, k)) for a in attns])
    return attn


def _cross_tree(blocks: list[XAttnBlock | DecBlock], io: _Leaves) -> dict:
    stack = _stacker(io)
    tree = {k: stack([_norm_leaf(getattr(b, k), io) for b in blocks])
            for k in ("norm1", "norm2", "norm3") if hasattr(blocks[0], k)}
    tree["xattn"] = _attn_leaves([b.xattn for b in blocks], stack, io)
    tree["mlp"] = _mlp_tree([b.mlp for b in blocks], stack, io)
    if isinstance(blocks[0], DecBlock):
        tree["attn"] = _attn_leaves([b.attn for b in blocks], stack, io)
    else:
        for k in ("gate_attn", "gate_mlp"):
            tree[k] = io.stack([io.arr(getattr(b, k)) for b in blocks])
    return tree


def _attn_tree(blocks: list[Block | MoEBlock], stack, io: _Leaves) -> dict:
    attn = _attn_leaves([b.attn for b in blocks], stack, io)
    norms = {k: stack([_norm_leaf(getattr(b, k), io) for b in blocks])
             for k in ("norm1", "norm2")}
    tree = {"norm1": norms["norm1"], "attn": attn, "norm2": norms["norm2"]}
    if not isinstance(blocks[0], MoEBlock):
        tree["mlp"] = _mlp_tree([b.mlp for b in blocks], stack, io)
        return tree
    moes = [b.moe for b in blocks]
    tree["moe"] = {"router": {"w": stack([_leaf(m.router, io)
                                          for m in moes])},
                   "experts": _mlp_tree([m.experts for m in moes], stack, io)}
    if moes[0].shared is not None:
        tree["moe"]["shared"] = _mlp_tree([m.shared for m in moes], stack,
                                          io)
        tree["moe"]["shared_gate"] = stack([_leaf(m.shared_gate, io)
                                            for m in moes])
    return tree


def _mamba_tree(blocks: list[MambaBlock], io: _Leaves) -> dict:
    stack = _stacker(io)
    mamba = {k: stack([_leaf(getattr(b.mamba, k), io) for b in blocks])
             for k in ("in_proj", "out_proj")}
    for k in _MAMBA_VECTORS:
        mamba[k] = io.stack([io.arr(getattr(b.mamba, k)) for b in blocks])
    return {"norm1": stack([_norm_leaf(b.norm1, io) for b in blocks]),
            "mamba": mamba}


def _xlstm_tree(kind: str, blocks: list, io: _Leaves) -> dict:
    _, _, leaves, floats = _XLSTM[kind]
    stack = _stacker(io)
    layers = [getattr(b, kind) for b in blocks]
    return {"norm1": stack([_norm_leaf(b.norm1, io) for b in blocks]),
            kind: {k: (io.stack([io.arr(getattr(x, k)) for x in layers])
                       if k in floats
                       else stack([_leaf(getattr(x, k), io) for x in layers]))
                   for k in leaves}}


def _reference_tree(params: LM | EncDec, cfg: ArchConfig | None,
                    io: _Leaves) -> dict:
    stack = _stacker(io)
    if isinstance(params, EncDec):
        enc = params.encoder
        return {"encoder": {
                    "pos_embed": io.arr(enc.pos_embed),
                    "layers": _attn_tree(list(enc.layers), stack, io),
                    "final_norm": _norm_leaf(enc.final_norm, io)},
                "decoder": _reference_tree(params.decoder, cfg, io)}
    pattern = ("attn",) if cfg is None else cfg.block_pattern
    per_pos = [list(params.layers)[pos::len(pattern)]
               for pos in range(len(pattern))]
    periods, tree = [], {}
    for kind, blocks in zip(pattern, per_pos):
        if kind == "shared_attn":
            periods.append(None)
            tree["shared"] = _attn_tree(blocks[:1], lambda xs: xs[0], io)
        elif kind == "mamba2":
            periods.append(_mamba_tree(blocks, io))
        elif kind in _XLSTM:
            periods.append(_xlstm_tree(kind, blocks, io))
        elif kind in ("xattn", "dec"):
            periods.append(_cross_tree(blocks, io))
        else:
            periods.append(_attn_tree(blocks, stack, io))
    tree.update(embed=io.arr(params.embed),
                final_norm=_norm_leaf(params.final_norm, io), periods=periods)
    if params.unembed is not None:
        tree["unembed"] = _leaf(params.unembed, io)
    return tree


def to_reference(params: LM | EncDec, cfg: ArchConfig | None = None) -> dict:
    """``LM`` or ``EncDec`` -> the reference's numpy tree layout (inverse
    of ``from_reference``); ``cfg`` gives the block pattern (default: the
    dense ``attn`` pattern)."""
    return _reference_tree(params, cfg, _NUMPY)


def reference_shapes(params: LM | EncDec,
                     cfg: ArchConfig | None = None) -> dict:
    """``to_reference``'s tree with a ``LeafShape`` for each leaf: the
    reference's layout of a tree on any device, ``meta`` included (no
    data is read), as ``jax.eval_shape`` gives the reference's."""
    return _reference_tree(params, cfg, _SHAPES)


def tree_to_reference(params: LM | EncDec, named: dict,
                      cfg: ArchConfig | None = None) -> dict:
    """``to_reference`` of ``params`` with each float parameter that
    ``named`` keys by its ``named_parameters`` name replaced by that tensor
    (a gradient, an optimizer moment): such tensors in the reference's tree
    layout, leaf for leaf.  ``params`` itself is left unchanged."""
    clone = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in clone.named_parameters():
            if name in named:
                p.data = named[name].detach().to(p.device, p.dtype)
    return to_reference(clone, cfg)


def reference_ndims(params: LM | EncDec,
                    cfg: ArchConfig | None = None) -> dict[str, int]:
    """The rank each ``named_parameters`` entry of a decoder (or an
    encoder-decoder) has as a leaf of the reference's tree: a layer's
    leaves are stacked over the periods there (one dimension more), an
    encoder layer's over ``n_encoder_layers``; the shared block's and the
    top-level leaves (embed, final norm, head, ``pos_embed``) are not.  The
    reference's AdamW decays every leaf of rank >= 2 (``_is_matrix``), so
    a layer's norm scales and biases are decayed and the final norm's are
    not (ROADMAP.md C19); ``train.optimizer`` takes these ranks to match
    it."""
    if isinstance(params, EncDec):
        out = {f"encoder.{name}": p.dim() + (name.split(".")[0] == "layers")
               for name, p in params.encoder.named_parameters()}
        out.update({f"decoder.{k}": v for k, v in
                    reference_ndims(params.decoder, cfg).items()})
        return out
    kinds = ("attn",) * len(params.layers) if cfg is None else cfg.block_kinds
    out = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "layers" and kinds[int(parts[1])] != "shared_attn"
        out[name] = p.dim() + stacked
    return out
