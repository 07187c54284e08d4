"""Convert the JAX reference's parameter tree (as numpy) into the port's
modules, and back.

``from_reference`` takes ``jax.device_get(params)`` of
``repro.models.init_params`` (optionally after ``ptq_quantize_params``): a
dict with ``embed``, ``final_norm``, ``unembed`` and ``periods[0]``, whose
leaves are stacked over layers.  It unstacks them into one ``Block`` per
layer and carries float leaves, the ``{w_q, scale}`` and ``{w4, qmul,
scale}`` PTQ dicts, the gated MLP's ``w_gate`` and the f32 embed/unembed
over unchanged.  ``to_reference`` is its inverse (the same
numpy tree layout), so a round trip reproduces the tree exactly.

This module speaks numpy and torch only; the tests hand it the reference's
arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.common import resolve_device
from .models.attention import Attention
from .models.blocks import Block
from .models.config import ArchConfig
from .models.layers import Linear, Norm
from .models.lm import LM
from .models.mlp import MLP


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _linear(leaf, i, dev) -> Linear:
    """Layer ``i`` of a stacked weight leaf (i=None: unstacked)."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if isinstance(leaf, dict):
        return Linear(**{k: _t(pick(v), dev) for k, v in leaf.items()})
    return Linear(_t(pick(leaf), dev))


def _norm(leaf, i, d, norm_type, dev) -> Norm:
    n = Norm(d, norm_type, dev)
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    n.scale.copy_(_t(pick(leaf["scale"]), dev))
    if n.bias is not None:
        n.bias.copy_(_t(pick(leaf["bias"]), dev))
    return n


def from_reference(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """numpy parameter tree of the reference -> ``LM`` on ``device`` (the
    card unless device='cpu')."""
    dev = resolve_device(device)
    if cfg.block_pattern != ("attn",) or "shared" in tree:
        raise NotImplementedError("only the dense 'attn' pattern is ported")
    per = tree["periods"][0]
    d, nt = cfg.d_model, cfg.norm_type
    layers = []
    for i in range(cfg.n_layers):
        a, m = per["attn"], per["mlp"]
        bias = {k: (_t(a[k][i], dev) if k in a else None)
                for k in ("bq", "bk", "bv")}
        attn = Attention(_linear(a["wq"], i, dev), _linear(a["wk"], i, dev),
                         _linear(a["wv"], i, dev), _linear(a["wo"], i, dev),
                         **bias)
        layers.append(Block(_norm(per["norm1"], i, d, nt, dev), attn,
                            _norm(per["norm2"], i, d, nt, dev),
                            MLP(_linear(m["w_in"], i, dev),
                                _linear(m["w_out"], i, dev),
                                _linear(m["w_gate"], i, dev)
                                if "w_gate" in m else None)))
    return LM(_t(tree["embed"], dev), layers,
              _norm(tree["final_norm"], None, d, nt, dev),
              _linear(tree["unembed"], None, dev))


def _leaf(lin: Linear):
    if lin.int4:
        return {k: getattr(lin, k).cpu().numpy()
                for k in ("w4", "qmul", "scale")}
    if lin.quantized:
        return {"w_q": lin.w_q.cpu().numpy(), "scale": lin.scale.cpu().numpy()}
    return lin.weight.detach().cpu().numpy()


def _stack(leaves: list):
    if isinstance(leaves[0], dict):
        return {k: np.stack([x[k] for x in leaves]) for k in leaves[0]}
    return np.stack(leaves)


def _norm_leaf(n: Norm) -> dict:
    out = {"scale": n.scale.detach().cpu().numpy()}
    if n.bias is not None:
        out["bias"] = n.bias.detach().cpu().numpy()
    return out


def to_reference(params: LM) -> dict:
    """``LM`` -> the reference's numpy tree layout (inverse of
    ``from_reference``)."""
    blocks = list(params.layers)
    attn = {k: _stack([_leaf(getattr(b.attn, k)) for b in blocks])
            for k in ("wq", "wk", "wv", "wo")}
    for k in ("bq", "bk", "bv"):
        if getattr(blocks[0].attn, k) is not None:
            attn[k] = np.stack([getattr(b.attn, k).cpu().numpy() for b in blocks])
    norms = {k: _stack([_norm_leaf(getattr(b, k)) for b in blocks])
             for k in ("norm1", "norm2")}
    per = {"norm1": norms["norm1"], "attn": attn, "norm2": norms["norm2"],
           "mlp": {k: _stack([_leaf(getattr(b.mlp, k)) for b in blocks])
                   for k in ("w_in", "w_out", "w_gate")
                   if getattr(blocks[0].mlp, k) is not None}}
    return {"embed": params.embed.detach().cpu().numpy(),
            "final_norm": _norm_leaf(params.final_norm),
            "periods": [per], "unembed": _leaf(params.unembed)}
