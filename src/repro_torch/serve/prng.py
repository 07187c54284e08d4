"""Threefry-2x32 PRNG streams, bit for bit those of ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable`` on, 64-bit types off), in plain PyTorch.

The serving engine samples as the reference does: one key per request,
``fold_in(PRNGKey(seed), submission id)``, folded again at each lane's fed
position, then ``categorical(key, logits / temperature)`` over the whole row
of logits.  Only these pieces of ``jax.random`` are ported:

* ``threefry2x32``: the 20-round Threefry-2x32 block cipher
  (``jax/_src/prng.py``, ``_threefry2x32_lowering``) on 32-bit words;
* ``prng_key``: ``PRNGKey(seed)`` without 64-bit types is ``(0, seed mod
  2^32)``;
* ``fold_in``: ``threefry2x32(key, (0, data))`` — the two words of
  ``threefry_seed(data)`` as one count pair;
* ``random_bits``: the partitionable layout: element i of a shape of n
  elements hashes the count pair (i >> 32, i mod 2^32) and returns the XOR
  of the two output words;
* ``uniform``: the top 23 bits of each word as the mantissa of a float in
  [1, 2), minus 1; then ``max(minval, u * (maxval - minval) + minval)``;
* ``gumbel`` ("low" mode, jax's default): ``-log(-log(uniform(tiny, 1)))``;
* ``categorical``: ``argmax(gumbel + logits)``, the first index on ties.

Words are held in int64 tensors masked to 32 bits after every add (torch's
uint32 lacks most operators), so the arithmetic is exact on any device.  The
bits and the uniforms are exact; ``log`` is the device's, which may differ
from XLA:CPU's by an ulp, so a Gumbel value may too (a categorical draw then
differs only where two perturbed logits are that close).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.common import f32

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = 1.1754943508222875e-38          # jnp.finfo(float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    """A 32-bit word (or words) as an int64 tensor in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pairs (x0, x1) under the key (k0, k1);
    all four broadcast, each an int64 tensor of 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: a (2,) int64 tensor of 32-bit words."""
    return _u32([0, int(seed) & MASK], device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of keys (..., 2) with 32-bit data (broadcast
    against the keys' leading shape); vmapped keys fold elementwise."""
    data = _u32(data, keys.device)
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` under each key of keys
    (..., 2): (..., *shape) int64 words (the partitionable counters)."""
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return (b0 ^ b1).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform`` of ``shape`` under each key."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = f32(minval, keys.device)
    span = f32(np.float32(maxval) - np.float32(minval), keys.device)
    return torch.maximum(lo, u * span + lo)


def gumbel(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """f32 ``jax.random.gumbel`` (mode "low") of ``shape`` under each key."""
    return -torch.log(-torch.log(uniform(keys, shape, F32_TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, l)`` over the last axis of logits
    (..., V), one key (..., 2) per row: int64 (...)."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
