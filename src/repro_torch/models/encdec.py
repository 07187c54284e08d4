"""Encoder-decoder model (whisper-style), port of ``repro.models.encdec``.

Encoder: ``n_encoder_layers`` ``enc`` blocks over the stub frontend's frame
embeddings plus a learned ``pos_embed``.  The reference's docstring calls it
bidirectional, but its ``block_forward`` never hands ``causal=False`` on, so
its encoder attends causally; the port reproduces that (ROADMAP C16).  The
frames are cast to the compute dtype and the f32 ``pos_embed`` added, which
promotes the stream to f32, as in the reference: every encoder block then
runs on f32 rows (its projections still round to the compute dtype) and the
encoder's output is f32.  Decoder: the decoder LM (``dec`` blocks: causal
self-attention with its KV cache, cross-attention to the encoder's output,
the MLP).

``encode``, ``encdec_forward`` and ``encdec_loss`` are differentiable, as
the reference's are: with grad enabled and weights that require grad they
build autograd's graph, and under ``cfg.remat`` each encoder block runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body), as the decoder's do (``lm.forward``).  Serving and scoring
callers run them under ``torch.no_grad``: on the card an integer kernel
refuses an input that requires grad (``kernels.common.on_cuda``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.common import generator_device, resolve_device
from .blocks import block_forward, init_block_params
from .config import ArchConfig
from .layers import Norm, apply_norm, embed_init
from .lm import (LM, _tracks_grad, exec_mode, init_params,
                 precompute_cross_states, xent_loss)
from .lm import forward as lm_forward


class Encoder(nn.Module):
    """``pos_embed`` [n_audio_frames, d] f32, one ``enc`` block per layer,
    the final norm."""

    def __init__(self, pos_embed: torch.Tensor, layers: list[nn.Module],
                 final_norm: Norm):
        super().__init__()
        self.pos_embed = nn.Parameter(pos_embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


class EncDec(nn.Module):
    """The encoder and the decoder ``LM``."""

    def __init__(self, encoder: Encoder, decoder: LM):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    @property
    def device(self) -> torch.device:
        return self.decoder.device


def init_encdec_params(cfg: ArchConfig, seed: int = 0, device=None,
                       precision: str | None = None) -> EncDec:
    """Random weights from ``seed`` on ``device`` (the card unless
    device='cpu'); with ``precision`` every block is quantized as it is
    built (``lm.init_params``)."""
    from ..quant.ptq import quantize_for
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder")
    dev = resolve_device(device)
    gen = torch.Generator(device=generator_device(dev)).manual_seed(seed)
    layers = []
    for _ in range(cfg.n_encoder_layers):
        block = init_block_params(gen, "enc", cfg, dev)
        layers.append(block if precision is None
                      else quantize_for(block, precision))
    enc = Encoder(embed_init(gen, cfg.n_audio_frames, cfg.d_model, dev),
                  layers, Norm(cfg.d_model, cfg.norm_type, dev))
    dec = init_params(cfg, seed=seed + 1, device=dev, precision=precision)
    return EncDec(enc, dec)


def encode(params: EncDec, cfg: ArchConfig, frames):
    """frames (B, S_audio, d) stub frontend output -> the encoder's output
    (B, S_audio, d), f32 (module note)."""
    mode = exec_mode(cfg)
    b, s, _ = frames.shape
    enc = params.encoder
    x = frames.to(mode.compute_dtype) + enc.pos_embed[None, :s]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    for block in enc.layers:
        if remat and _tracks_grad(block, x):
            x, _ = checkpoint(block_forward, "enc", block, x, cfg, mode,
                              positions, use_reentrant=False)
        else:
            x, _ = block_forward("enc", block, x, cfg, mode, positions)
    return apply_norm(x, enc.final_norm, cfg, mode)[0]


def encdec_forward(params: EncDec, cfg: ArchConfig, frames, tokens,
                   states=None, positions=None, enc_out=None):
    """The whole encoder-decoder step: (logits, states, enc_out).  Pass
    ``enc_out`` to skip re-encoding (decode: the cross K/V in ``states``
    were filled by the prefill call); with ``states`` and a fresh encoding
    the states' cross K/V are filled first."""
    fresh = enc_out is None
    if fresh:
        enc_out = encode(params, cfg, frames)
    if states is not None and fresh:
        states = precompute_cross_states(params.decoder, cfg, enc_out, states)
    logits, states = lm_forward(params.decoder, cfg, tokens,
                                positions=positions, states=states,
                                kv_source=enc_out)
    return logits, states, enc_out


def encdec_loss(params: EncDec, cfg: ArchConfig, frames, tokens, labels):
    """Mean next-token cross entropy of the decoder over labels >= 0."""
    lg, _, _ = encdec_forward(params, cfg, frames, tokens)
    return xent_loss(lg, labels)
