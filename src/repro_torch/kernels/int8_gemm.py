"""int8 x int8 -> int32 GEMM with fused epilogues.

Port of the Pallas kernel ``repro/kernels/int8_gemm.py:127`` ``int8_gemm`` to
the CUDA kernel ``csrc/int8_gemm.cu`` (source note there: bound by bytes at
decode and by operations at prefill; 64x64 ``__dp4a`` tiles, split K with an
exact int32 combine when the tiles alone cannot fill the card).  The
epilogues the serving path runs are ported:

  none         int32 accumulator out
  scaled       f32 dequant ``acc * xs * ws`` (+ bias), cast to the stream dtype
  scaled_add   scaled, then + residual in the stream dtype
  scaled_gelu  scaled, then integer GELU at a static scale -> int8

``gemm_w8a8_ref`` is the plain version, ``repro.kernels.ref.gemm_w8a8_ref``
as ``jax.jit`` runs it on XLA:CPU: the bias-free dequant is two separate
multiplies ``(acc*xs)*ws``; with a bias it is one fused multiply-add
``fma(acc*xs, ws, bias)``; ``h / gelu_scale`` is ``h * f32(1/gelu_scale)``.
Kernel and plain version are bit-exact.  The plain int32 accumulator is an
f64 matmul, exact while K * 128 * 128 < 2^53.
"""
from __future__ import annotations

import torch

from . import build
from .common import LAUNCHES, cdiv, check, fma_f32, on_cuda, rcp32
from .int_gelu import gelu_consts, int_gelu_ref

I32 = torch.int32
EPILOGUES = ("none", "scaled", "scaled_add", "scaled_gelu")
_EPI_CODE = {e: i for i, e in enumerate(EPILOGUES)}
BM = BN = BK = 64


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulator of int8 [M, K] x int8 [K, N] (f64 matmul:
    plain int32 matmul does not run on CUDA)."""
    check(x.shape[-1] * 128 * 128 < 2 ** 53, "K too deep for an exact f64 sum")
    return (x.double() @ w.double()).to(I32)


def gemm_w8a8_ref(x_q, x_scale, w_q, w_scale, bias=None, residual=None,
                  gelu_scale=None, out_dtype=torch.bfloat16):
    """Plain W8A8 linear: int8 GEMM -> f32 rescale (-> int GELU | + res).

    x_q [M, K] int8, x_scale [M, 1] f32, w_q [K, N] int8, w_scale [N] f32,
    bias [N] f32, residual [M, N] in ``out_dtype``."""
    acc = int8_matmul_ref(x_q, w_q)
    p = acc.float() * x_scale
    if bias is None:
        h = p * w_scale
    else:
        h = fma_f32(p, w_scale.expand_as(p), bias.expand_as(p))
    if gelu_scale is not None:
        h = h.to(out_dtype).float()
        rcp = torch.tensor(rcp32(gelu_scale), device=h.device)
        q = torch.clamp(torch.round(h * rcp), -128, 127).to(I32)
        return int_gelu_ref(q, gelu_scale)
    h = h.to(out_dtype)
    if residual is not None:
        h = h + residual
    return h


class _Workspace:
    """Self-cleaning split-K scratch of one device: int32 partial sums and
    per-tile arrival counters, zero between launches (the last block of each
    tile resets what it used).  Launches on one stream share it."""

    def __init__(self):
        self.partial: dict[torch.device, torch.Tensor] = {}
        self.counters: dict[torch.device, torch.Tensor] = {}

    def get(self, device, n_partial: int, n_tiles: int):
        p = self.partial.get(device)
        if p is None or p.numel() < n_partial:
            p = self.partial[device] = torch.zeros(max(n_partial, 1 << 16),
                                                   dtype=I32, device=device)
        c = self.counters.get(device)
        if c is None or c.numel() < n_tiles:
            c = self.counters[device] = torch.zeros(max(n_tiles, 1 << 12),
                                                    dtype=I32, device=device)
        return p, c


_WORKSPACE = _Workspace()


def split_k(m: int, n: int, k: int, n_sm: int) -> tuple[int, int]:
    """(split, k_len): split K across blocks until about two blocks per SM
    are in flight; k_len is a multiple of BK and every split is non-empty."""
    tiles = cdiv(m, BM) * cdiv(n, BN)
    steps = cdiv(k, BK)
    split = max(1, min(steps, cdiv(2 * n_sm, tiles)))
    k_len = cdiv(steps, split) * BK
    return cdiv(k, k_len), k_len


def _launch(x, w, epilogue, x_scale, w_scale, bias, residual, gelu_scale,
            out_dtype):
    check(x.dtype == torch.int8 and w.dtype == torch.int8 and x.dim() == 2
          and w.dim() == 2 and x.shape[1] == w.shape[0],
          f"int8 GEMM operands: x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
          f"{tuple(w.shape)}")
    check(x.is_contiguous() and w.is_contiguous(), "GEMM operands must be "
          "contiguous")
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    xs = ws = b = r = 0                  # NULL unless the epilogue reads it
    stream_f32 = int(out_dtype == torch.float32)
    if epilogue == "none":
        out = torch.empty((m, n), dtype=I32, device=dev)
    else:
        check(out_dtype in (torch.bfloat16, torch.float32),
              f"stream dtype must be bf16 or f32, got {out_dtype}")
        check(x_scale.dtype == torch.float32 and x_scale.numel() == m
              and x_scale.is_contiguous(), "x_scale must be contiguous f32 [M, 1]")
        check(w_scale.dtype == torch.float32 and w_scale.numel() == n
              and w_scale.is_contiguous(), "w_scale must be contiguous f32 [N]")
        xs, ws = x_scale.data_ptr(), w_scale.data_ptr()
        if bias is not None:
            check(bias.dtype == torch.float32 and bias.numel() == n
                  and bias.is_contiguous(), "bias must be contiguous f32 [N]")
            b = bias.data_ptr()
        if epilogue == "scaled_add":
            check(residual.dtype == out_dtype and tuple(residual.shape) == (m, n)
                  and residual.is_contiguous(),
                  f"residual must be contiguous {out_dtype} [M, N]")
            r = residual.data_ptr()
        out = torch.empty((m, n), device=dev, dtype=torch.int8
                          if epilogue == "scaled_gelu" else out_dtype)
    consts = (0,) * 6
    inv = 0.0
    if epilogue == "scaled_gelu":
        consts = gelu_consts(gelu_scale)
        inv = float(rcp32(gelu_scale))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split, k_len = split_k(m, n, k, n_sm)
    part, cnt = _WORKSPACE.get(dev, m * n if split > 1 else 0,
                               cdiv(m, BM) * cdiv(n, BN))
    vec = int(k % 16 == 0 and n % 4 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    fn = build.entry("int8_gemm", "repro_int8_gemm",
                     [build.VP] * 2 + [build.I] * 5 + [build.VP] * 5
                     + [build.F] + [build.I] * 9 + [build.VP] * 3)
    rc = fn(x.data_ptr(), w.data_ptr(), m, n, k, _EPI_CODE[epilogue], stream_f32,
            xs, ws, b, r, out.data_ptr(), inv, *consts, split, k_len, vec,
            part.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_rc(rc, "int8_gemm")
    LAUNCHES["int8_gemm"] += 1
    return out


def int8_gemm(x, w, epilogue: str = "none", *, x_scale=None, w_scale=None,
              bias=None, residual=None, gelu_scale=None,
              out_dtype=torch.bfloat16):
    """x [M, K] int8 @ w [K, N] int8 with a fused epilogue: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    check(epilogue in EPILOGUES, f"epilogue {epilogue!r} not in {EPILOGUES}")
    check((epilogue == "scaled_gelu") == (gelu_scale is not None),
          "gelu_scale goes with the scaled_gelu epilogue")
    check((epilogue == "scaled_add") == (residual is not None),
          "residual goes with the scaled_add epilogue")
    if on_cuda(x, w, x_scale, w_scale, bias, residual):
        return _launch(x, w, epilogue, x_scale, w_scale, bias, residual,
                       gelu_scale, out_dtype)
    if epilogue == "none":
        return int8_matmul_ref(x, w)
    return gemm_w8a8_ref(x, x_scale, w, w_scale, bias=bias, residual=residual,
                         gelu_scale=gelu_scale, out_dtype=out_dtype)
