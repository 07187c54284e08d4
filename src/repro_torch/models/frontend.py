"""Modality frontends, stubs as in the reference (``repro.models.frontend``).

``[audio]`` / ``[vlm]`` architectures specify the transformer backbone; the
frontend supplies precomputed frame or patch embeddings.  These helpers make
deterministic synthetic features of the right shapes from an explicit
``torch.Generator``, and a real patch embedder that runs the integer conv
kernel (``ops.conv2d_i8``), so the frontend path is executable end to end.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.common import check, f32, resolve_device


def audio_frames_stub(gen: torch.Generator, batch: int, n_frames: int,
                      d_model: int, device=None) -> torch.Tensor:
    """Whisper conv-stem output stand-in: (B, n_frames, d_model)."""
    return torch.randn((batch, n_frames, d_model), generator=gen,
                       device=resolve_device(device)) * 0.02


def vision_tokens_stub(gen: torch.Generator, batch: int, n_tokens: int,
                       d_model: int, device=None) -> torch.Tensor:
    """ViT feature stand-in for cross-attention: (B, n_tokens, d_model)."""
    return torch.randn((batch, n_tokens, d_model), generator=gen,
                       device=resolve_device(device)) * 0.02


def patch_embed_operands(gen: torch.Generator | None, images: torch.Tensor,
                         d_model: int, patch: int = 16,
                         weight: torch.Tensor | None = None):
    """The int8 operands of ``conv_patch_embed_int8``: the patchified image
    (B, H/p, W/p, p*p*3), the weight (1, 1, p*p*3, d_model), and the
    weight's f32 scale.

    images: (B, H, W, 3) float in [-1, 1], on the device it runs on.  The
    weight is a standard normal draw from ``gen``, or ``weight`` when given.
    The reference runs this eagerly, so every division here is a true
    division (by a tensor: PyTorch multiplies by the reciprocal when a CUDA
    tensor is divided by a Python number)."""
    b, h, w, c = images.shape
    check(h % patch == 0 and w % patch == 0,
          f"a {h}x{w} image is not whole {patch}x{patch} patches")
    dev = images.device
    x = images.float().reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // patch, w // patch, -1)
    xi = torch.clamp(torch.round(x * 127.0), -128, 127).to(torch.int8)
    shape = (1, 1, patch * patch * c, d_model)
    wf = (torch.randn(shape, generator=gen, device=dev) if weight is None
          else weight.float().to(dev))
    check(tuple(wf.shape) == shape, f"weight {tuple(wf.shape)} is not {shape}")
    wf = wf / torch.sqrt(f32(patch * patch * c, dev))
    ws = torch.maximum(wf.abs().max(), f32(1e-8, dev)) / f32(127.0, dev)
    wi = torch.clamp(torch.round(wf / ws), -128, 127).to(torch.int8)
    return xi.contiguous(), wi, ws


def conv_patch_embed_int8(gen: torch.Generator | None, images: torch.Tensor,
                          d_model: int, patch: int = 16,
                          weight: torch.Tensor | None = None) -> torch.Tensor:
    """Patch embedder on the int8 conv kernel: (B, H, W, 3) float images in
    [-1, 1] -> (B, H/p * W/p, d_model) f32.  The image and the weight are
    quantized to int8 (``patch_embed_operands``) and the conv kernel runs as
    a strided patchify (non-overlapping windows = a reshape, then a 1x1 conv
    over p*p*3 channels)."""
    xi, wi, ws = patch_embed_operands(gen, images, d_model, patch, weight)
    bias = torch.zeros((d_model,), dtype=torch.int32, device=xi.device)
    acc = ops.conv2d_i8(xi, wi, bias)             # (B, H/p, W/p, d) int32
    out = acc.float() * (ws / f32(127.0, xi.device))
    return out.reshape(images.shape[0], -1, d_model)
