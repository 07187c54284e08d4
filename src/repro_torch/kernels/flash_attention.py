"""bf16 attention forward (the no-cache bf16 path): q [B,H,S,D] against
k/v [B,Hkv,Skv,D], causal or not, f32 online softmax, bf16 out.

Port of the Pallas kernel ``repro/kernels/flash_attention.py:74``
``flash_attention`` to the CUDA kernel ``csrc/flash_attention.cu`` (source
note there: both products on bf16 tensor cores, K/V streamed by
``cp.async``, one block per 64 query rows, key tiles above the diagonal
skipped).  ``flash_attention_ref`` is its plain version,
``repro.kernels.ref``'s oracle: f32 scores, softmax and P@V, rounded to the
input dtype once.  The two sum in other orders and use their own ``exp``, and
the kernel carries P into P@V as two bf16 terms, so they agree within
``|kernel - plain| <= ATOL + RTOL * |plain|``: one bf16 rounding of the
output (2^-7 relative at most), ATOL for outputs near 0.
``flash_attention_tiled_ref`` is the kernel's order in plain PyTorch.

Gradients: on the card the kernel launches inside ``_FlashAttention``, a
``torch.autograd.Function`` whose forward is the kernel and whose backward
recomputes the plain version from the saved q/k/v and returns autograd's
gradients of it (GQA's ``repeat_interleave`` folds dk/dv back over the
shared heads).  No backward kernel exists: the reference has none — it
trains through ``ref.flash_attention_ref`` and XLA's autodiff of it — so the
port's backward is the counterpart of that autodiff, and the input
gradients equal autograd of the plain version bit for bit.  On the CPU
autograd differentiates the plain version directly.
"""
from __future__ import annotations

import math

import torch

from . import build
from .common import LAUNCHES, check, on_cuda, plain_grads

NEG = -1e30
RTOL = 2.0 ** -7
ATOL = 1e-3
BK = 64                      # the kernel's key tile
LOG2E = 1.4426950408889634


def head_dim_ok(d: int) -> bool:
    """The head dims both no-cache attention kernels take: multiples of 16
    up to 128 (16 reduced; 64, 80 and 128 at full width)."""
    return d % 16 == 0 and 16 <= d <= 128


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, skv), dtype=torch.bool,
                          device=q.device).tril(skv - s)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, causal: bool = True, scale=None,
                              bk: int = BK, split: bool = True):
    """The kernel's order in plain PyTorch: key tiles of ``bk`` in order,
    an f32 online softmax per tile (``exp(x) = exp2(x * log2 e)``), l summing
    the f32 probabilities, and P split into two bf16 terms before P@V,
    ``hi = bf16(p)``, ``lo = bf16(p - hi)`` (``split=False``: ``hi`` alone,
    one bf16 rounding, which misses ``RTOL``/``ATOL`` on early causal rows,
    where one probability carries the row).  It shows on the CPU that the
    kernel's rounding fits the tolerance; the wrappers never call it."""
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(s, device=q.device)[:, None] + (skv - s)
    m = torch.full((b, h, s, 1), NEG, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for k0 in range(0, skv, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        x = torch.einsum("bhsd,bhtd->bhst", qf, kt) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None]
            x = torch.where(keys <= rows, x, torch.full_like(x, NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((x - m_new) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhst,bhtd->bhsd", hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhst,bhtd->bhsd", lo, vt)
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _launch(q, k, v, causal: bool, scale: float):
    b, h, s, d = q.shape
    _, hkv, skv, d2 = k.shape
    check(d2 == d and tuple(v.shape) == tuple(k.shape) and h % hkv == 0
          and k.shape[0] == b, f"q {tuple(q.shape)} k {tuple(k.shape)} "
          f"v {tuple(v.shape)}")
    check(head_dim_ok(d), f"head_dim {d}: the kernel takes multiples of 16 "
          f"up to 128")
    for t in (q, k, v):
        check(t.dtype == torch.bfloat16, f"q/k/v must be bf16, got {t.dtype}")
    check(skv >= 1, "no keys")
    check(not causal or s == skv, f"causal attention needs S == Skv "
          f"(got {s}, {skv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = build.entry("flash_attention", "repro_flash_attention",
                     [build.VP] * 4 + [build.I] * 6 + [build.F, build.I,
                                                       build.VP])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            hkv, s, skv, d, float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """forward: the CUDA kernel; backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, dout):
        return plain_grads(flash_attention_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], dout, ctx.causal,
                           ctx.scale) + (None, None)


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """bf16 attention of q [B,H,S,D] against k/v [B,Hkv,Skv,D] -> [B,H,S,D]:
    the CUDA kernel for CUDA tensors (under ``_FlashAttention``), the plain
    version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cuda(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_ref(q, k, v, causal, scale)
