"""Integer GEMMs with fused epilogues: W8A8 (int8 weights), W4A8 (packed
int4 weights with two-level group scales) and the gated-MLP dual GEMMs.

Ports of the Pallas kernels of ``repro/kernels/int8_gemm.py`` to CUDA
kernels for ``sm_90a`` (source notes in each ``csrc`` file).  All four run
the tensor-core loop of ``csrc/gemm_mma.cuh`` (``mma.sync`` on int8 or bf16,
the raw weight tiles streamed by ``cp.async`` in the reference's layout and
turned into fragments at the ``ldmatrix`` load), templated on the weight's
kind — packed int4 with the group fold (W4), int8 (W8) or bf16 — with tiles
chosen by ``autotune``'s ``gemm_blocks``, ``gemm_w4a8_blocks``,
``gated_mlp_blocks`` and ``gatedmlp_w4a8_blocks``.  The integer
GEMMs split K with an exact int32 combine when the tiles alone cannot fill
the card; the bf16 form never splits K:

  int8_gemm             (``:127``) -> ``csrc/int8_gemm.cu``: W8
  int4_gemm             (``:433``) -> ``csrc/int4_gemm.cu``: W4
  dual_gemm_gated       (``:280``) -> ``csrc/dual_gemm_gated.cu``: 2 x W8, BF16
  dual_int4_gemm_gated  (``:568``) -> ``csrc/dual_int4_gemm_gated.cu``: 2 x W4

The single-stream epilogues, the reference's seven (int8_gemm takes all;
int4_gemm the scaled family):

  none          int32 accumulator out
  requant       shift/mul16/shift requant of the accumulator -> int8
  requant_gelu  integer GELU of the accumulator at a static scale -> int8
  requant_add   requant, then a saturating int8 residual add -> int8
  scaled        f32 dequant (+ bias), cast to the stream dtype
  scaled_gelu   scaled, then integer GELU at a static scale -> int8
  scaled_add    scaled, then + residual in the stream dtype

The serving paths run the scaled family; the requant family is the
integer-in, integer-out GEMM of the paper's Table II (``ops.gemm_i8``,
``gemm_i8_gelu``, ``gemm_i8_add``).

The plain versions are ``repro.kernels.ref``'s oracles as ``jax.jit`` runs
them on XLA:CPU, and every integer kernel is bit-exact against its plain
version:

* the dequant chain is ``(acc*xs)*ws`` at W8A8 and ``(acc*ws)*xs`` at W4A8
  (the reference writes them in those orders; f32 rounds them differently);
  with a bias, the last multiply and the add are one FMA;
* ``h / scale`` by a Python-float constant is ``h * f32(1/scale)``;
* the gate's integer activation is dequantized by one f32 multiply and
  rounded to bf16, and ``act * up`` is one bf16 multiply.

Expert-batched forms (the port's counterpart of the reference's ``jax.vmap``
of these kernels over a MoE layer's experts, ``repro/models/moe.py:114``):
``int8_gemm_experts`` and ``int4_gemm_experts`` (the ``scaled`` epilogue),
``dual_gemm_gated_experts`` (int8 and bf16) and
``dual_int4_gemm_gated_experts`` take a leading expert dimension — x [E, M,
K], weights, multipliers, scales and outputs stacked over E — in ONE launch:
the same kernel, its grid's z = expert * split + the K split, every pointer
moved to the block's expert (``Slice`` in ``csrc/gemm_mma.cuh``).  The
unbatched wrappers launch it with E = 1, so each expert's output is the
unbatched kernel's on that expert's rows bit for bit (the bf16 form never
splits K and takes the same tile at the same M).  Their tiles follow the
unbatched rules at M rows, with the SMs shared among the experts' tiles
(``n_sm / E`` in the split rule).  The plain versions apply the unbatched
plain version to each expert.

The plain int32 sums are exact float matmuls: f64 for int8 weights (K*128*128
< 2^53), f32 per W4 scale group (g*128*8 < 2^24), combined in int32.  The
bf16 ``dual_gemm_gated`` sums in f32 and applies the float activation in
f32, so it agrees with its unfused plain version ``gated_mlp_ref`` to a
tolerance (``DUAL_BF16_RTOL``/``DUAL_BF16_ATOL``), not bit for bit.  It is
the one form with a gradient, unbatched and expert-batched: on the card
both launch inside ``_DualGemmGated`` (over [E, M, K], E = 1 for the
unbatched wrapper), which saves x and the two weights and whose backward
recomputes ``gated_mlp_ref`` per expert under autograd (no backward
kernel: the reference has none).  The integer forms launch outside
autograd: the wrappers outside ``common.GRAD_KERNELS`` raise on an input
that requires grad under grad mode (``common.on_cuda``), and the int8
operands of the dual GEMMs' integer form carry no gradient.
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from . import autotune, build
from .autotune import BF16_BK, W4_BK, W4_STAGES, W8_BK
from .common import (LAUNCHES, cdiv, check, check_requant, f32, fma_f32,
                     on_cuda, plain_grads, rcp32)
from .int_gelu import gelu_consts, gelu_out_scale, int_gelu_ref
from .int_silu import int_silu_ref, silu_consts, silu_out_scale

I32 = torch.int32
EPILOGUES = ("none", "requant", "requant_gelu", "requant_add",
             "scaled", "scaled_gelu", "scaled_add")
W4A8_EPILOGUES = ("scaled", "scaled_add", "scaled_gelu")
_EPI_CODE = {e: i for i, e in enumerate(EPILOGUES)}
GATED_ACTS = ("silu", "gelu")
# |kernel - plain| <= DUAL_BF16_ATOL + DUAL_BF16_RTOL * |plain| for the bf16
# dual_gemm_gated: the plain version rounds h, g, act(g) and the product to
# bf16 (each <= 2^-9 relative; the SiLU's relative slope, 1 + g*(1 -
# sigmoid(g)), can double g's error), the kernel rounds once; f32 sums in
# another order add ~1e-6.  Outputs below ~0.03 (a strongly negative gate)
# fall under the absolute term.
DUAL_BF16_RTOL = 2.0 ** -5
DUAL_BF16_ATOL = 1e-3


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 accumulator of int8 [M, K] x int8 [K, N] (f64 matmul:
    plain int32 matmul does not run on CUDA)."""
    check(x.shape[-1] * 128 * 128 < 2 ** 53, "K too deep for an exact f64 sum")
    return (x.double() @ w.double()).to(I32)


def int8_gemm_ref(x, w, requant=None):
    """Plain int8 GEMM (``ref.int8_gemm_ref``): the int32 accumulator, or
    with ``requant`` (``RequantParams``) the int8 requantized one."""
    acc = int8_matmul_ref(x, w)
    if requant is None:
        return acc
    return inum.requantize(acc, requant).to(torch.int8)


def int8_gemm_gelu_ref(x, w, gelu_scale: float):
    """Plain ``requant_gelu`` (``ref.int8_gemm_gelu_ref``): the int32
    accumulator -> integer GELU at ``gelu_scale`` -> int8."""
    return int_gelu_ref(int8_matmul_ref(x, w), gelu_scale)


def int8_gemm_add_ref(x, w, requant, residual):
    """Plain ``requant_add`` (``ref.int8_gemm_add_ref``): the requantized
    accumulator plus the int residual, saturated to int8."""
    q = inum.requantize(int8_matmul_ref(x, w), requant)
    return torch.clamp(q + residual.to(I32), -128, 127).to(torch.int8)


def _dequant(acc, first, second, bias):
    """f32 dequant of an int32 sum in the reference's order: ``first`` is
    the scale it multiplies by first; a bias makes the last step one FMA."""
    p = acc.float() * first
    if bias is None:
        return p * second
    return fma_f32(p, second.expand_as(p), bias.expand_as(p))


def _finish(h, residual, gelu_scale, out_dtype):
    """The scaled epilogues past the dequant: int GELU at a static scale
    (int8 out), or the stream dtype (+ residual)."""
    if gelu_scale is not None:
        h = h.to(out_dtype).float()
        q = torch.clamp(torch.round(h * f32(rcp32(gelu_scale), h.device)),
                        -128, 127).to(I32)
        return int_gelu_ref(q, gelu_scale)
    h = h.to(out_dtype)
    if residual is not None:
        h = h + residual
    return h


def gemm_w8a8_ref(x_q, x_scale, w_q, w_scale, bias=None, residual=None,
                  gelu_scale=None, out_dtype=torch.bfloat16):
    """Plain W8A8 linear: int8 GEMM -> f32 rescale (-> int GELU | + res).

    x_q [M, K] int8, x_scale [M, 1] f32, w_q [K, N] int8, w_scale [N] f32,
    bias [N] f32, residual [M, N] in ``out_dtype``."""
    h = _dequant(int8_matmul_ref(x_q, w_q), x_scale, w_scale, bias)
    return _finish(h, residual, gelu_scale, out_dtype)


def _gate(g, act, act_scale, out_dtype):
    """The integer gate of the gated MLP: the stream-dtype gate requantized
    at the static ``act_scale``, integer SiLU/GELU, dequantized by one f32
    multiply into the stream dtype."""
    q = torch.clamp(torch.round(g.float() * f32(rcp32(act_scale), g.device)),
                    -128, 127).to(I32)
    if act == "silu":
        pay, out_scale = int_silu_ref(q, act_scale), silu_out_scale(act_scale)
    else:
        pay, out_scale = int_gelu_ref(q, act_scale), gelu_out_scale(act_scale)
    return (pay.float() * f32(out_scale, g.device)).to(out_dtype)


def gated_mlp_ref(x, w_up, w_gate, act="silu", compute_dtype=torch.bfloat16):
    """Plain float gated MLP, as the reference's model composes it: two
    compute-dtype GEMMs, the float activation of the gate, a multiply.  Each
    GEMM sums the compute-dtype products in f32 and rounds once, as XLA:CPU
    does (cuBLAS's bf16 GEMM may reduce split-K partials in bf16)."""
    xc = x.to(compute_dtype).float()
    h = (xc @ w_up.to(compute_dtype).float()).to(compute_dtype)
    g = (xc @ w_gate.to(compute_dtype).float()).to(compute_dtype)
    a = (torch.nn.functional.silu(g) if act == "silu"
         else torch.nn.functional.gelu(g, approximate="none"))
    return a * h


def gated_mlp_w8a8_ref(x_q, x_scale, w_up_q, up_scale, w_gate_q, gate_scale,
                       act="silu", act_scale=None, out_dtype=torch.bfloat16):
    """Plain W8A8 gated MLP: two scaled W8A8 GEMMs over the same quantized
    activations -> integer activation of the gate -> multiply."""
    h = gemm_w8a8_ref(x_q, x_scale, w_up_q, up_scale, out_dtype=out_dtype)
    g = gemm_w8a8_ref(x_q, x_scale, w_gate_q, gate_scale, out_dtype=out_dtype)
    return _gate(g, act, act_scale, out_dtype) * h


def unpack_int4_ref(packed, k):
    """packed int8 [..., ceil(K/2), N] -> sign-extended int8 [..., K, N]
    (the inverse of ``quantize.pack_int4``): the low nibble of byte i is
    row 2i, ``((b & 0xF) ^ 8) - 8``; the high nibble row 2i+1, a floor
    division by 16."""
    p = packed.to(I32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = torch.div(p, 16, rounding_mode="floor")
    kp, n = packed.shape[-2], packed.shape[-1]
    w = torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], 2 * kp, n)
    return w[..., :k, :].to(torch.int8)


# the deepest contraction whose int32 group combine keeps the reference's
# headroom, |sum_g part_g * qmul_g| <= K * 128 * 8 * 127 < 2^31 (asserted by
# the reference's W4A8 GEMMs); the port's PTQ keeps deeper weights int8
W4_MAX_K = (2 ** 31 - 1) // (128 * 8 * 127)


def w4_group(k: int, qmul: torch.Tensor) -> int:
    """The scale group size of a W4 weight with contraction depth ``k``;
    checks the reference's headroom bounds."""
    groups = qmul.shape[-2]
    g = k // groups
    check(g * groups == k and g * 128 * 8 < 2 ** 24,
          f"K={k} is not {groups} groups of an f32-exact size")
    check(k <= W4_MAX_K, f"K={k} overflows the int32 combine")
    return g


def int4_matmul_ref(x_q, w4, qmul):
    """Exact int32 group combine sum_g (x_g . w_g) * qmul[g] of int8
    [M, K] x packed int4 [K/2, N]: each group's partial is an f32 batched
    matmul (exact: |partial| <= g*128*8 < 2^24), cast to int32 and
    multiplied by its int8 multiplier; the sum over groups is integer."""
    m, k = x_q.shape
    g = w4_group(k, qmul)
    groups, n = qmul.shape
    w = unpack_int4_ref(w4, k).float().reshape(groups, g, n)
    xg = x_q.float().reshape(m, groups, g).transpose(0, 1)      # [G, M, g]
    part = torch.bmm(xg, w).to(I32)                             # [G, M, N]
    return (part * qmul.to(I32)[:, None, :]).sum(0, dtype=torch.int64).to(I32)


def gemm_w4a8_ref(x_q, x_scale, w4, qmul, w_scale, bias=None, residual=None,
                  gelu_scale=None, out_dtype=torch.bfloat16):
    """Plain W4A8 linear: nibble unpack -> per-group int8 x int4 GEMM ->
    integer group combine -> ONE f32 rescale ``(acc*ws)*xs`` (-> int GELU |
    + res).  x_q [M, K] int8, x_scale [M, 1], w4 [K/2, N] packed, qmul
    [K/g, N] int8, w_scale [N] f32."""
    h = _dequant(int4_matmul_ref(x_q, w4, qmul), w_scale, x_scale, bias)
    return _finish(h, residual, gelu_scale, out_dtype)


def gated_mlp_w4a8_ref(x_q, x_scale, up4, up_mul, up_scale, gate4, gate_mul,
                       gate_scale, act="silu", act_scale=None,
                       out_dtype=torch.bfloat16):
    """Plain W4A8 gated MLP: two group-scaled W4A8 GEMMs over the same
    quantized activations -> integer activation of the gate -> multiply."""
    h = gemm_w4a8_ref(x_q, x_scale, up4, up_mul, up_scale, out_dtype=out_dtype)
    g = gemm_w4a8_ref(x_q, x_scale, gate4, gate_mul, gate_scale,
                      out_dtype=out_dtype)
    return _gate(g, act, act_scale, out_dtype) * h


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


# (k per stage, bytes of an activation, shared rows of a weight stage,
# bytes of a weight column in a row) of each kind (``gemm_mma.cuh``)
MMA_KINDS = {"w4": (W4_BK, 1, W4_BK // 2, 1), "w8": (W8_BK, 1, W8_BK, 1),
             "bf16": (BF16_BK, 2, BF16_BK, 2)}
SMEM_PER_BLOCK, SMEM_PER_SM = 232448, 233472   # H100: a block's limit, an SM's


def mma_smem_bytes(kind: str, bm: int, bn: int, streams: int) -> int:
    """Dynamic shared memory of a ``gemm_mma.cuh`` launch (its ``Stage``
    ``SMEM``): W4_STAGES x (A [bm][BK * a + 16] + streams x (weight
    [rows][bn * w + 16] + W4's qmul rows [BK/32][bn]))."""
    bk, a_elem, w_rows, w_elem = MMA_KINDS[kind]
    q = bk // 32 * bn if kind == "w4" else 0
    return W4_STAGES * (bm * (bk * a_elem + 16)
                        + streams * (w_rows * (bn * w_elem + 16) + q))


def _n_sm(dev, experts: int = 1) -> int:
    """The SMs one expert's tiles may count on: all of them, or an E-th of
    them in an expert-batched launch (its E experts' tiles share the card,
    so the split rule counts every expert's blocks)."""
    return cdiv(torch.cuda.get_device_properties(dev).multi_processor_count,
                experts)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_i8(t, shape, what):
    check(t.dtype == torch.int8 and tuple(t.shape) == tuple(shape)
          and t.is_contiguous(),
          f"{what}: want contiguous int8 {tuple(shape)}, got "
          f"{t.dtype} {tuple(t.shape)}")


def _check_f32(t, numel, what):
    check(t.dtype == torch.float32 and t.numel() == numel and t.is_contiguous(),
          f"{what} must be contiguous f32 with {numel} values")


def _epilogue_args(epilogue, m, n, x_scale, w_scale, bias, residual,
                   gelu_scale, out_dtype, dev, requant=None, experts: int = 1):
    """(output tensor [E, M, N], C arguments from ``epilogue`` to the
    requant consts) of the single-stream epilogues (``Epi`` in
    ``csrc/int_epilogue.cuh``); an expert-batched launch (E > 1) takes row
    scales [E, M] and column scales [E, N], and no bias or residual."""
    xs = ws = b = r = 0                  # NULL unless the epilogue reads it
    rq = (0, 0, 0)
    e = experts
    check(e == 1 or (bias is None and residual is None),
          "the expert-batched GEMMs take no bias or residual")
    if epilogue == "none":
        out = torch.empty((e, m, n), dtype=I32, device=dev)
    elif epilogue.startswith("requant"):
        out = torch.empty((e, m, n), dtype=torch.int8, device=dev)
        if epilogue != "requant_gelu":
            check_requant(requant)
            rq = (requant.s1, requant.mult, requant.s2)
        if epilogue == "requant_add":
            _check_i8(residual, (m, n), "int8 residual [M, N]")
            r = residual.data_ptr()
    else:
        check(out_dtype in (torch.bfloat16, torch.float32),
              f"stream dtype must be bf16 or f32, got {out_dtype}")
        _check_f32(x_scale, e * m, "x_scale [M, 1]")
        _check_f32(w_scale, e * n, "w_scale [N]")
        xs, ws = x_scale.data_ptr(), w_scale.data_ptr()
        if bias is not None:
            _check_f32(bias, n, "bias [N]")
            b = bias.data_ptr()
        if epilogue == "scaled_add":
            check(residual.dtype == out_dtype and tuple(residual.shape) == (m, n)
                  and residual.is_contiguous(),
                  f"residual must be contiguous {out_dtype} [M, N]")
            r = residual.data_ptr()
        out = torch.empty((e, m, n), device=dev, dtype=torch.int8
                          if epilogue == "scaled_gelu" else out_dtype)
    consts, inv = (0,) * 6, 0.0
    if epilogue.endswith("gelu"):
        consts, inv = gelu_consts(gelu_scale), float(rcp32(gelu_scale))
    return out, (_EPI_CODE[epilogue], int(out_dtype == torch.float32), xs, ws,
                 b, r, out.data_ptr(), inv, *consts, *rq)


_EPI_ARGTYPES = ([build.I] * 2 + [build.VP] * 5 + [build.F] + [build.I] * 9)


def _check_epilogue(epilogue, epilogues, gelu_scale, residual, requant=None):
    check(epilogue in epilogues, f"epilogue {epilogue!r} not in {epilogues}")
    check(epilogue.endswith("gelu") == (gelu_scale is not None),
          "gelu_scale goes with the scaled_gelu and requant_gelu epilogues")
    check(epilogue.endswith("add") == (residual is not None),
          "residual goes with the scaled_add and requant_add epilogues")
    check((epilogue in ("requant", "requant_add")) == (requant is not None),
          "requant params go with the requant and requant_add epilogues")


def _count(kernel: str, experts: int) -> None:
    """One launch of ``kernel``; an expert-batched one also counts as
    ``<kernel>.experts``."""
    LAUNCHES[kernel] += 1
    if experts > 1:
        LAUNCHES[f"{kernel}.experts"] += 1


def _launch(x, w, epilogue, x_scale, w_scale, bias, residual, gelu_scale,
            out_dtype, requant):
    """x [E, M, K] @ w [E, K, N] in one launch (E = 1: the unbatched GEMM);
    returns [E, M, N]."""
    check(x.dim() == 3 and w.dim() == 3 and x.shape[2] == w.shape[1]
          and x.shape[0] == w.shape[0],
          f"int8 GEMM operands: x {tuple(x.shape)}, w {tuple(w.shape)}")
    e, m, k = x.shape
    n = w.shape[2]
    _check_i8(x, (e, m, k), "x")
    _check_i8(w, (e, k, n), "w")
    out, epi = _epilogue_args(epilogue, m, n, x_scale, w_scale, bias,
                              residual, gelu_scale, out_dtype, x.device,
                              requant, experts=e)
    dev = x.device
    tl = autotune.gemm_blocks(m, k, n, _n_sm(dev, e))
    part, cnt = _WORKSPACE.get(dev, e * tl.workspace, e * tl.tiles)
    vec = int(k % 16 == 0 and n % 16 == 0 and _aligned(x, w))
    fn = build.entry("int8_gemm", "repro_int8_gemm",
                     [build.I] + [build.VP] * 2 + [build.I] * 3 + _EPI_ARGTYPES
                     + [build.I] * 4 + [build.VP] * 3)
    rc = fn(e, x.data_ptr(), w.data_ptr(), m, n, k, *epi, tl.bm, tl.split,
            tl.k_len, vec, part.data_ptr(), cnt.data_ptr(), _stream(dev))
    build.check_rc(rc, "int8_gemm")
    _count("int8_gemm", e)
    return out


def int8_gemm(x, w, epilogue: str = "none", *, x_scale=None, w_scale=None,
              bias=None, residual=None, gelu_scale=None, requant=None,
              out_dtype=torch.bfloat16):
    """x [M, K] int8 @ w [K, N] int8 with a fused epilogue (``requant``:
    ``RequantParams`` of the requant and requant_add epilogues): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_epilogue(epilogue, EPILOGUES, gelu_scale, residual, requant)
    if on_cuda(x, w, x_scale, w_scale, bias, residual):
        check(x.dim() == 2 and w.dim() == 2,
              f"int8 GEMM operands: x {tuple(x.shape)}, w {tuple(w.shape)}")
        return _launch(x[None], w[None], epilogue, x_scale, w_scale, bias,
                       residual, gelu_scale, out_dtype, requant)[0]
    if epilogue in ("none", "requant"):
        return int8_gemm_ref(x, w, requant)
    if epilogue == "requant_gelu":
        return int8_gemm_gelu_ref(x, w, gelu_scale)
    if epilogue == "requant_add":
        return int8_gemm_add_ref(x, w, requant, residual)
    return gemm_w8a8_ref(x, x_scale, w, w_scale, bias=bias, residual=residual,
                         gelu_scale=gelu_scale, out_dtype=out_dtype)


def _launch_int4(x, w4, qmul, w_scale, x_scale, epilogue, gelu_scale, bias,
                 residual, out_dtype):
    """x [E, M, K] @ unpack(w4) [E, K, N] in one launch (E = 1: the
    unbatched GEMM); returns [E, M, N]."""
    check(x.dim() == 3 and w4.dim() == 3 and qmul.dim() == 3,
          f"W4 GEMM operands: x {tuple(x.shape)}, w4 {tuple(w4.shape)}")
    e, m, k = x.shape
    n = w4.shape[-1]
    g = w4_group(k, qmul)
    check(g in (32, 64, 128), f"W4 group {g} is not 32, 64 or 128")
    _check_i8(x, (e, m, k), "x")
    _check_i8(w4, (e, k // 2, n), "w4 [K/2, N]")
    _check_i8(qmul, (e, k // g, n), "qmul [K/g, N]")
    out, epi = _epilogue_args(epilogue, m, n, x_scale, w_scale, bias,
                              residual, gelu_scale, out_dtype, x.device,
                              experts=e)
    dev = x.device
    tl = autotune.gemm_w4a8_blocks(m, k, n, g, _n_sm(dev, e))
    part, cnt = _WORKSPACE.get(dev, e * tl.workspace, e * tl.tiles)
    vec = int(k % 16 == 0 and n % 16 == 0 and _aligned(x, w4, qmul))
    fn = build.entry("int4_gemm", "repro_int4_gemm",
                     [build.I] + [build.VP] * 3 + [build.I] * 4 + _EPI_ARGTYPES
                     + [build.I] * 4 + [build.VP] * 3)
    rc = fn(e, x.data_ptr(), w4.data_ptr(), qmul.data_ptr(), m, n, k, g, *epi,
            tl.bm, tl.split, tl.k_len, vec, part.data_ptr(),
            cnt.data_ptr(), _stream(dev))
    build.check_rc(rc, "int4_gemm")
    _count("int4_gemm", e)
    return out


def int4_gemm(x, w4, qmul, w_scale, x_scale, epilogue: str = "scaled", *,
              gelu_scale=None, bias=None, residual=None,
              out_dtype=torch.bfloat16):
    """x [M, K] int8 @ unpack(w4) [K, N] int4 with two-level scales (group
    multipliers qmul [K/g, N], column scales w_scale [N]) and a fused
    epilogue: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    _check_epilogue(epilogue, W4A8_EPILOGUES, gelu_scale, residual)
    if on_cuda(x, w4, qmul, w_scale, x_scale, bias, residual):
        check(x.dim() == 2, f"x must be [M, K], got {tuple(x.shape)}")
        return _launch_int4(x[None], w4[None], qmul[None], w_scale, x_scale,
                            epilogue, gelu_scale, bias, residual,
                            out_dtype)[0]
    return gemm_w4a8_ref(x, x_scale, w4, qmul, w_scale, bias=bias,
                         residual=residual, gelu_scale=gelu_scale,
                         out_dtype=out_dtype)


def _act_args(act, act_scale):
    """C arguments of the integer gate (``Act`` in ``int_epilogue.cuh``)."""
    if act == "silu":
        out_scale, silu, gelu = silu_out_scale(act_scale), silu_consts(act_scale), (0,) * 6
    else:
        out_scale, silu, gelu = gelu_out_scale(act_scale), (0,) * 4, gelu_consts(act_scale)
    return (GATED_ACTS.index(act), float(rcp32(act_scale)), out_scale, *silu,
            *gelu)


_ACT_ARGTYPES = [build.I, build.F, build.F] + [build.I] * 10


def _check_gated(x, act, act_scale, out_dtype, scales):
    check(act in GATED_ACTS, f"act {act!r} not in {GATED_ACTS}")
    check(out_dtype == torch.bfloat16, "the gated MLP kernels write bf16")
    if x.dtype == torch.int8:
        check(act_scale is not None and all(s is not None for s in scales),
              "the integer gated MLP needs the three scales and act_scale")


def _launch_dual(x, w_up, w_gate, x_scale, up_scale, gate_scale, act,
                 act_scale):
    """x [E, M, K] against w_up, w_gate [E, K, N] in one launch (E = 1: the
    unbatched kernel); returns [E, M, N]."""
    check(x.dim() == 3 and w_up.dim() == 3 and x.shape[2] == w_up.shape[1]
          and x.shape[0] == w_up.shape[0],
          f"dual GEMM operands: x {tuple(x.shape)}, w {tuple(w_up.shape)}")
    e, m, k = x.shape
    n = w_up.shape[2]
    out = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    if x.dtype == torch.int8:
        _check_i8(x, (e, m, k), "x")
        _check_i8(w_up, (e, k, n), "w_up")
        _check_i8(w_gate, (e, k, n), "w_gate")
        _check_f32(x_scale, e * m, "x_scale [M, 1]")
        _check_f32(up_scale, e * n, "up_scale [N]")
        _check_f32(gate_scale, e * n, "gate_scale [N]")
        tl = autotune.gated_mlp_blocks(m, k, n, "int8", _n_sm(x.device, e))
        part, cnt = _WORKSPACE.get(x.device, e * tl.workspace, e * tl.tiles)
        vec = int(k % 16 == 0 and n % 16 == 0 and _aligned(x, w_up, w_gate))
        fn = build.entry("dual_gemm_gated", "repro_dual_gemm_gated_i8",
                         [build.I] + [build.VP] * 6 + [build.I] * 3
                         + _ACT_ARGTYPES + [build.VP] + [build.I] * 4
                         + [build.VP] * 3)
        rc = fn(e, x.data_ptr(), w_up.data_ptr(), up_scale.data_ptr(),
                w_gate.data_ptr(), gate_scale.data_ptr(), x_scale.data_ptr(),
                m, n, k, *_act_args(act, act_scale), out.data_ptr(), tl.bm,
                tl.split, tl.k_len, vec, part.data_ptr(), cnt.data_ptr(),
                _stream(x.device))
    else:
        for t, what in ((x, "x"), (w_up, "w_up"), (w_gate, "w_gate")):
            check(t.dtype == torch.bfloat16 and t.is_contiguous(),
                  f"{what} of the float gated MLP must be contiguous bf16, "
                  f"got {t.dtype}")
        check(tuple(w_gate.shape) == (e, k, n), "w_gate must match w_up")
        vec = int(k % 8 == 0 and n % 8 == 0 and _aligned(x, w_up, w_gate))
        fn = build.entry("dual_gemm_gated", "repro_dual_gemm_gated_bf16",
                         [build.I] + [build.VP] * 3 + [build.I] * 6
                         + [build.VP] * 2)
        rc = fn(e, x.data_ptr(), w_up.data_ptr(), w_gate.data_ptr(), m, n, k,
                GATED_ACTS.index(act),
                autotune.gated_mlp_blocks(m, k, n, "bf16",
                                          _n_sm(x.device, e)).bm, vec,
                out.data_ptr(), _stream(x.device))
    build.check_rc(rc, "dual_gemm_gated")
    _count("dual_gemm_gated", e)
    return out


class _DualGemmGated(torch.autograd.Function):
    """The bf16 gated MLP hidden of E experts, x [E, M, K] against w_up,
    w_gate [E, K, N] (E = 1: the unbatched form): forward one CUDA launch,
    backward autograd of the plain version — ``gated_mlp_ref`` on each
    expert's slice (``per_expert``) — recomputed from the three saved
    inputs, no intermediate of the kernel kept.  The reference has no
    backward kernel (it trains through ``ref.gated_mlp_ref``, vmapped over
    the experts, and XLA's autodiff), so none is written here; the input
    gradients equal autograd of the plain version bit for bit."""

    @staticmethod
    def forward(ctx, x, w_up, w_gate, act):
        ctx.save_for_backward(x, w_up, w_gate)
        ctx.act = act
        return _launch_dual(x, w_up, w_gate, None, None, None, act, None)

    @staticmethod
    def backward(ctx, dout):
        return plain_grads(_gated_experts_ref, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], dout, ctx.act) + (None,)


def _gated_experts_ref(x, w_up, w_gate, act):
    return per_expert(lambda *a: gated_mlp_ref(*a, act), x, w_up, w_gate)


def dual_gemm_gated(x, w_up, w_gate, x_scale=None, up_scale=None,
                    gate_scale=None, act: str = "silu", act_scale=None,
                    out_dtype=torch.bfloat16):
    """act(x @ w_gate) * (x @ w_up) with both GEMMs fused.  int8 x (W8A8):
    needs the three scales and the static ``act_scale``; bf16 x: float
    activation, differentiable (``_DualGemmGated`` on the card).  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_gated(x, act, act_scale, out_dtype, (x_scale, up_scale, gate_scale))
    if on_cuda(x, w_up, w_gate, x_scale, up_scale, gate_scale):
        check(x.dim() == 2 and w_up.dim() == 2,
              f"dual GEMM operands: x {tuple(x.shape)}, w {tuple(w_up.shape)}")
        if x.dtype != torch.int8:
            return _DualGemmGated.apply(x[None], w_up[None], w_gate[None],
                                        act)[0]
        return _launch_dual(x[None], w_up[None], w_gate[None], x_scale,
                            up_scale, gate_scale, act, act_scale)[0]
    if x.dtype == torch.int8:
        return gated_mlp_w8a8_ref(x, x_scale, w_up, up_scale, w_gate,
                                  gate_scale, act=act, act_scale=act_scale,
                                  out_dtype=out_dtype)
    return gated_mlp_ref(x, w_up, w_gate, act, out_dtype)


def _launch_dual_int4(x, up4, up_mul, up_scale, gate4, gate_mul, gate_scale,
                      x_scale, act, act_scale):
    """x [E, M, K] against two W4 streams [E, K/2, N] in one launch (E = 1:
    the unbatched kernel); returns [E, M, N]."""
    check(x.dim() == 3 and up4.dim() == 3 and up_mul.dim() == 3,
          f"x must be [E, M, K], got {tuple(x.shape)}")
    e, m, k = x.shape
    n = up4.shape[-1]
    g = w4_group(k, up_mul)
    check(g in (32, 64, 128), f"W4 group {g} is not 32, 64 or 128")
    _check_i8(x, (e, m, k), "x")
    for t, what in ((up4, "up4"), (gate4, "gate4")):
        _check_i8(t, (e, k // 2, n), f"{what} [K/2, N]")
    for t, what in ((up_mul, "up_mul"), (gate_mul, "gate_mul")):
        _check_i8(t, (e, k // g, n), f"{what} [K/g, N]")
    _check_f32(x_scale, e * m, "x_scale [M, 1]")
    _check_f32(up_scale, e * n, "up_scale [N]")
    _check_f32(gate_scale, e * n, "gate_scale [N]")
    out = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    dev = x.device
    tl = autotune.gatedmlp_w4a8_blocks(m, k, n, g, _n_sm(dev, e))
    part, cnt = _WORKSPACE.get(dev, e * tl.workspace, e * tl.tiles)
    vec = int(k % 16 == 0 and n % 16 == 0
              and _aligned(x, up4, gate4, up_mul, gate_mul))
    fn = build.entry("dual_int4_gemm_gated", "repro_dual_int4_gemm_gated",
                     [build.I] + [build.VP] * 8 + [build.I] * 4 + _ACT_ARGTYPES
                     + [build.VP] + [build.I] * 4 + [build.VP] * 3)
    rc = fn(e, x.data_ptr(), up4.data_ptr(), up_mul.data_ptr(),
            up_scale.data_ptr(), gate4.data_ptr(), gate_mul.data_ptr(),
            gate_scale.data_ptr(), x_scale.data_ptr(), m, n, k, g,
            *_act_args(act, act_scale), out.data_ptr(), tl.bm, tl.split,
            tl.k_len, vec, part.data_ptr(), cnt.data_ptr(), _stream(dev))
    build.check_rc(rc, "dual_int4_gemm_gated")
    _count("dual_int4_gemm_gated", e)
    return out


def dual_int4_gemm_gated(x, up4, up_mul, up_scale, gate4, gate_mul,
                         gate_scale, x_scale, act: str = "silu",
                         act_scale=None, out_dtype=torch.bfloat16):
    """act(x @ gate4) * (x @ up4), both W4A8 GEMMs fused over one shared A:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_gated(x, act, act_scale, out_dtype, (x_scale, up_scale, gate_scale))
    if on_cuda(x, up4, up_mul, up_scale, gate4, gate_mul, gate_scale, x_scale):
        check(x.dim() == 2, f"x must be [M, K], got {tuple(x.shape)}")
        return _launch_dual_int4(x[None], up4[None], up_mul[None], up_scale,
                                 gate4[None], gate_mul[None], gate_scale,
                                 x_scale, act, act_scale)[0]
    return gated_mlp_w4a8_ref(x, x_scale, up4, up_mul, up_scale, gate4,
                              gate_mul, gate_scale, act=act,
                              act_scale=act_scale, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# the expert-batched forms: one launch over a MoE layer's E experts
# ---------------------------------------------------------------------------

def per_expert(fn, *args):
    """The plain version of an expert-batched form: ``fn`` (an unbatched
    plain version) on each expert's slice of every tensor argument (None
    passes through), stacked over E."""
    e = args[0].shape[0]
    return torch.stack([fn(*(None if a is None else a[i] for a in args))
                        for i in range(e)])


def _check_experts(x, *stacked):
    check(x.dim() == 3 and all(t is None or t.shape[0] == x.shape[0]
                               for t in stacked),
          f"expert-batched operands must share a leading E: x "
          f"{tuple(x.shape)}, " + ", ".join(str(tuple(t.shape))
                                            for t in stacked if t is not None))


def int8_gemm_experts(x, w, x_scale, w_scale, out_dtype=torch.bfloat16):
    """The W8A8 ``scaled`` GEMM of every expert in one launch: x [E, M, K]
    int8 with row scales [E, M, 1], w [E, K, N] int8 with column scales
    [E, N] -> [E, M, N] in ``out_dtype``.  CPU tensors: the unbatched plain
    version per expert."""
    _check_experts(x, w, x_scale, w_scale)
    if on_cuda(x, w, x_scale, w_scale):
        return _launch(x, w, "scaled", x_scale, w_scale, None, None, None,
                       out_dtype, None)
    return per_expert(lambda *a: gemm_w8a8_ref(*a, out_dtype=out_dtype),
                      x, x_scale, w, w_scale)


def int4_gemm_experts(x, w4, qmul, w_scale, x_scale, out_dtype=torch.bfloat16):
    """The W4A8 ``scaled`` GEMM of every expert in one launch: x [E, M, K]
    int8, w4 [E, K/2, N] packed int4, qmul [E, K/g, N], w_scale [E, N],
    x_scale [E, M, 1] -> [E, M, N].  CPU tensors: the unbatched plain version
    per expert."""
    _check_experts(x, w4, qmul, w_scale, x_scale)
    if on_cuda(x, w4, qmul, w_scale, x_scale):
        return _launch_int4(x, w4, qmul, w_scale, x_scale, "scaled", None,
                            None, None, out_dtype)
    return per_expert(lambda *a: gemm_w4a8_ref(*a, out_dtype=out_dtype),
                      x, x_scale, w4, qmul, w_scale)


def dual_gemm_gated_experts(x, w_up, w_gate, x_scale=None, up_scale=None,
                            gate_scale=None, act: str = "silu",
                            act_scale=None):
    """act(x @ w_gate) * (x @ w_up) of every expert in one launch: x [E, M,
    K] int8 (with the scales [E, M, 1], [E, N], [E, N] and ``act_scale``) or
    bf16 (differentiable: ``_DualGemmGated`` on the card), weights [E, K,
    N] -> bf16 [E, M, N].  CPU tensors: the unbatched plain version per
    expert."""
    _check_gated(x, act, act_scale, torch.bfloat16,
                 (x_scale, up_scale, gate_scale))
    _check_experts(x, w_up, w_gate, x_scale, up_scale, gate_scale)
    if on_cuda(x, w_up, w_gate, x_scale, up_scale, gate_scale):
        if x.dtype != torch.int8:
            return _DualGemmGated.apply(x, w_up, w_gate, act)
        return _launch_dual(x, w_up, w_gate, x_scale, up_scale, gate_scale,
                            act, act_scale)
    if x.dtype == torch.int8:
        return per_expert(lambda *a: gated_mlp_w8a8_ref(
            *a, act=act, act_scale=act_scale), x, x_scale, w_up, up_scale,
            w_gate, gate_scale)
    return _gated_experts_ref(x, w_up, w_gate, act)


def dual_int4_gemm_gated_experts(x, up4, up_mul, up_scale, gate4, gate_mul,
                                 gate_scale, x_scale, act: str = "silu",
                                 act_scale=None):
    """The W4A8 gated MLP hidden of every expert in one launch: x [E, M, K]
    int8, each stream [E, K/2, N] with multipliers [E, K/g, N] and scales
    [E, N], x_scale [E, M, 1] -> bf16 [E, M, N].  CPU tensors: the unbatched
    plain version per expert."""
    _check_gated(x, act, act_scale, torch.bfloat16,
                 (x_scale, up_scale, gate_scale))
    _check_experts(x, up4, up_mul, up_scale, gate4, gate_mul, gate_scale,
                   x_scale)
    if on_cuda(x, up4, up_mul, up_scale, gate4, gate_mul, gate_scale, x_scale):
        return _launch_dual_int4(x, up4, up_mul, up_scale, gate4, gate_mul,
                                 gate_scale, x_scale, act, act_scale)
    return per_expert(lambda *a: gated_mlp_w4a8_ref(
        *a, act=act, act_scale=act_scale), x, x_scale, up4, up_mul, up_scale,
        gate4, gate_mul, gate_scale)
