"""Shared helpers for the port's kernels: devices, launch counts, exact float
helpers, and the in-register integer requant (``requant_block``).

Dispatch rule for every kernel wrapper: a tensor on the CPU takes the
kernel's plain PyTorch version; a tensor on a CUDA device launches the CUDA
kernel or raises.  Nothing falls back from the card to the plain version.
A launch is outside autograd, so on the card a wrapper raises rather than
launch on an input that requires grad while grad mode is on — except the
wrappers whose kernels run inside a ``torch.autograd.Function``
(``GRAD_KERNELS``: flash_attention, ssd_scan, the bf16 forms of
dual_gemm_gated, unbatched and expert-batched, and bf16_gemm), whose
backward is autograd
of the plain version.  On the CPU autograd differentiates the plain
versions directly.

Two behaviours of the JAX reference under ``jax.jit`` on XLA:CPU decide
bit-exactness, and every plain version and kernel here keeps them:

1. A division by a Python-float constant becomes a multiply by its f32
   reciprocal (``amax / 127.0`` is ``amax * f32(1/127)``); a division by a
   traced value stays a true division.  ``rcp32`` gives that reciprocal.
2. The bias epilogue ``acc*xs*ws + bias`` is FMA-contracted: one rounding of
   ``(acc*xs)*ws + bias``.  ``fma_f32`` computes that exactly in PyTorch;
   the CUDA kernels call ``__fmaf_rn``.
"""
from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from . import build

# Launch counts of the CUDA kernels: each wrapper adds one where it launches
# its kernel, and nowhere else.  ``ops.launch_counts``/``reset_launch_counts``
# read and clear them.
LAUNCHES: collections.Counter = collections.Counter()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (or for ``meta``: shapes without data).  With no device
    given and no card present this raises — entry points never fall back to
    the CPU on their own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {device!r} (cpu, cuda or "
                         f"meta: shapes only, for launch/dryrun.py)")
    return dev


def generator_device(dev: torch.device) -> torch.device:
    """The device of an init's generator: ``dev``'s own, the CPU's for a
    meta tree (its draws are shapes only)."""
    return torch.device("cpu") if dev.type == "meta" else dev


# the wrappers whose kernels launch inside a torch.autograd.Function
GRAD_KERNELS = ("flash_attention", "ssd_scan", "dual_gemm_gated",
                "dual_gemm_gated_experts", "bf16_gemm")


def tensor_device(tensors) -> torch.device:
    """The one device of a kernel's inputs (None entries skipped)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devs))}")
    return next(iter(devs))


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the kernel should launch: every tensor on one CUDA device.
    CPU tensors take the plain version; anything else raises.  On the card,
    an input that requires grad while grad mode is on raises, naming the
    kernel (the calling wrapper): the launch would lose its gradient.  The
    wrappers of ``GRAD_KERNELS`` carry it through their Function."""
    dev = tensor_device(tensors)
    if dev.type == "cuda":
        kernel = sys._getframe(1).f_code.co_name
        if (kernel not in GRAD_KERNELS and torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in tensors)):
            raise RuntimeError(
                f"{kernel}: an input requires grad, and the CUDA kernel "
                f"runs outside autograd — it would drop the gradient (its "
                f"backward is not ported; run under torch.no_grad, or train "
                f"this path on the CPU)")
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def plain_grads(plain, inputs, needs, dout, *args):
    """autograd's gradients of ``plain(*inputs, *args)`` against ``dout``
    for the inputs whose ``needs`` is set (None for the others), the plain
    version recomputed from detached copies of ``inputs``: the backward of
    a kernel whose TPU original has no backward kernel.  A plain version
    with several outputs takes a tuple ``dout``; an output whose entry is
    None (unused: its gradient is zero) is left out of the backward."""
    douts = dout if isinstance(dout, tuple) else (dout,)
    used = [i for i, d in enumerate(douts) if d is not None]
    if not (any(needs) and used):
        return (None,) * len(needs)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves, *args)
        outs = out if isinstance(dout, tuple) else (out,)
        got = iter(torch.autograd.grad(
            [outs[i] for i in used], [t for t in leaves if t.requires_grad],
            [douts[i] for i in used]))
    return tuple(next(got) if n else None for n in needs)


def rcp32(c: float) -> np.float32:
    """The f32 reciprocal XLA multiplies by when a jitted function divides
    by the Python-float constant ``c`` (finding 1)."""
    return np.float32(1.0) / np.float32(c)


def rcp(d: int) -> tuple[int, int]:
    """The exact reciprocal (m, sh) of a divisor 1 <= d < 2^31 for
    numerators 0 <= n < 2^31: floor(n / d) == (n * m) >> sh, with
    sh = 31 + ceil(log2 d) and m = ceil(2^sh / d) < 2^32 (m * d - 2^sh < d,
    so n * (m * d - 2^sh) < 2^sh).  ``csrc/int_exp.cuh`` ``rcp`` computes
    the same on the card: int_softmax and int8_flash_attention take
    q_ln2's from their wrappers and compute the exp-sum l's once per row."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"rcp: divisor {d} outside [1, 2^31)")
    sh = 31 + (d - 1).bit_length()
    return -(-(1 << sh) // d), sh


_CONSTS: dict = {}


def f32(v, device) -> torch.Tensor:
    """A 0-dim float32 tensor: keeps scalar arithmetic in f32.  Built once
    per (value, device) and shared, so a forward on the card copies no
    constant from the host after its first step.  Read it only; never
    write into it."""
    key = (float(np.float32(v)), torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(np.float32(v), dtype=torch.float32,
                                        device=key[1])
    return t


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 fused multiply-add ``a*b + c`` (one rounding).

    The f64 product of two f32 values is exact.  The f64 sum with ``c`` is
    turned into round-to-odd (TwoSum error term; an inexact even result
    steps one ulp toward the exact value), and rounding a round-to-odd
    f64 (53 bits >= 24 + 2) to f32 gives the correctly rounded result."""
    p = a.double() * b.double()
    cd = c.double().expand_as(p)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    # +1 on the magnitude bits moves away from zero for either sign
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(fix, bits + step, bits)
    return bits.view(torch.float64).float()


def requant_block(acc: torch.Tensor, s1: int, mult: int, s2: int) -> torch.Tensor:
    """Shift/mul16/shift requantization of an int32 block to the int8 range
    (round-half-up) — the in-register form of ``core.inumerics.requantize``
    that every integer epilogue shares.  Its CUDA twin is
    ``requant_block`` in ``csrc/int_epilogue.cuh``."""
    if s1 > 0:
        acc = (acc + (1 << (s1 - 1))) >> s1
    acc = torch.clamp(acc, -(1 << 15), (1 << 15) - 1) * mult
    if s2 > 0:
        acc = (acc + (1 << (s2 - 1))) >> s2
    return torch.clamp(acc, -128, 127)


def check(cond: bool, msg: str) -> None:
    """Validate a kernel argument (survives ``python -O``, unlike assert)."""
    if not cond:
        raise ValueError(msg)


def check_requant(p) -> None:
    """The requant params a kernel takes: shifts in [0, 30] (a C shift by 31
    or more is undefined) and a multiplier below 2^15 (the int16 operand
    times it stays in int32)."""
    check(0 <= p.s1 <= 30 and 0 <= p.s2 <= 30 and 0 <= p.mult < 2 ** 15,
          f"requant params {p} out of the kernels' range")


def launch_elementwise(source: str, kernel: str, x: torch.Tensor, out_dtype,
                       consts) -> torch.Tensor:
    """Launch ``repro_<kernel>`` of ``csrc/<source>.cu`` (an
    ``elementwise.cuh`` map) over the int payload ``x`` of any shape: int8
    and int16 payloads are widened to int32 first; the C entry takes
    (x, out, n, *consts, vec, stream)."""
    check(x.dtype in (torch.int8, torch.int16, torch.int32),
          f"{kernel} takes an int payload, got {x.dtype}")
    x32 = x.to(torch.int32).contiguous()
    check(x32.numel() < 2 ** 31, f"{kernel}: {x32.numel()} values > int32")
    out = torch.empty(x32.shape, dtype=out_dtype, device=x.device)
    vec = int(x32.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = build.entry(source, f"repro_{kernel}",
                     [build.VP, build.VP] + [build.I] * (len(consts) + 2)
                     + [build.VP])
    rc = fn(x32.data_ptr(), out.data_ptr(), x32.numel(), *consts, vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_rc(rc, kernel)
    LAUNCHES[kernel] += 1
    return out
