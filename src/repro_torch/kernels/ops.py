"""Public entry points for the port's kernels (mirrors ``repro.kernels.ops``).

Call sites (models, serving engine) go through these wrappers, which take
arbitrary leading dims and flatten them to the kernels' 2-D rows.  Dispatch
goes by the tensor's device, never by a global switch: CPU tensors take the
kernels' plain PyTorch versions, CUDA tensors launch the CUDA kernels.  Each
kernel counts its launches; ``launch_counts`` / ``reset_launch_counts`` read
and clear the counts.
"""
from __future__ import annotations

import torch

from .bf16_gemm import bf16_gemm
from .common import LAUNCHES
from .conv2d import int8_conv2d
from .flash_attention import flash_attention
from .int8_flash_attention import int8_flash_attention
from .int8_gemm import (dual_gemm_gated, dual_gemm_gated_experts,
                        dual_int4_gemm_gated, dual_int4_gemm_gated_experts,
                        int4_gemm, int4_gemm_experts, int8_gemm,
                        int8_gemm_experts)
from .int8_kv_decode_attention import (int8_kv_decode_attention,
                                       int8_kv_decode_attention_rows)
from .int_gelu import int_gelu
from .int_layernorm import int_layernorm, int_layernorm_rows
from .int_silu import int_silu
from .int_softmax import int_softmax
from .paged_attention import (paged_decode_attention,
                              paged_decode_attention_rows)
from .quantize import quantize_rows, requantize_i32
from .ssd_scan import ssd_scan

# the ports of the reference's sixteen Pallas kernels, then the kernel the
# port adds beyond them: the bf16 float linear, whose sums keep one order
# at any row or column count (ROADMAP C20)
TPU_KERNELS = ("quantize_rows", "int8_gemm", "int_layernorm",
               "int8_kv_decode_attention", "dual_gemm_gated", "int4_gemm",
               "dual_int4_gemm_gated", "paged_decode_attention",
               "int_softmax", "int8_flash_attention", "flash_attention",
               "int_gelu", "int_silu", "requantize_i32", "int8_conv2d",
               "ssd_scan")
KERNELS = TPU_KERNELS + ("bf16_gemm",)


# launches counted a second time by form: the GEMMs' expert-batched
# launches, the decode kernels' launches with a sliding window, their
# multi-row launches, and int8_flash_attention's streaming form
FORMS = ("int8_gemm.experts", "int4_gemm.experts", "dual_gemm_gated.experts",
         "dual_int4_gemm_gated.experts", "int8_kv_decode_attention.window",
         "paged_decode_attention.window", "int8_kv_decode_attention.rows",
         "paged_decode_attention.rows", "int8_flash_attention.streaming")


def launch_counts(forms: bool = False) -> dict[str, int]:
    """Launches of each kernel since the last reset; with ``forms`` also
    the counts by form (``FORMS``)."""
    return {k: LAUNCHES[k] for k in KERNELS + (FORMS if forms else ())}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def quant_rows(x: torch.Tensor):
    """float [..., D] -> (int8 [..., D], f32 [..., 1]) per-row absmax.
    bf16 and f32 rows go to the kernel as they are; another float dtype is
    widened to f32 first."""
    lead, d = x.shape[:-1], x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    q, s = quantize_rows(x.reshape(-1, d).contiguous())
    return q.reshape(*lead, d), s.reshape(*lead, 1)


def norm_quant_rows(x, gamma_q, beta_q, gb_s, rms_only: bool = False):
    """The models' integer norm of float rows [..., D] (int32 payloads
    gamma_q/beta_q [D] on the 0-dim f32 scale gb_s) fused with the row
    quantization of its output: (normed rows in x's dtype [..., D], int8
    [..., D], f32 [..., 1]) — what ``layernorm_i8`` between two
    ``quant_rows`` computes, in one launch."""
    lead, d = x.shape[:-1], x.shape[-1]
    h, q, s = int_layernorm_rows(x.reshape(-1, d).contiguous(), gamma_q,
                                 beta_q, gb_s, rms_only=rms_only)
    return h.reshape(*lead, d), q.reshape(*lead, d), s.reshape(*lead, 1)


def gemm_bf16(x, w, bias=None):
    """The bf16 float linear of [..., K] x [K, N] (+ bias [N]):
    ``layers.linear`` at bf16 (x, w and bias cast to bf16, f32 sums, one
    rounding, the bias added in bf16), one kernel launch on the card whose
    sums keep one order at any M or N.  Differentiable."""
    lead, k = x.shape[:-1], x.shape[-1]
    bf = torch.bfloat16
    out = bf16_gemm(x.to(bf).reshape(-1, k), w.to(bf),
                    None if bias is None else bias.to(bf))
    return out.reshape(*lead, w.shape[1])


def gemm_i8(x, w, requant=None):
    """int8 GEMM of [..., K] x [K, N]: the int32 accumulator, or with
    ``requant`` (``RequantParams``) int8 through shift/mul16/shift."""
    lead, k = x.shape[:-1], x.shape[-1]
    out = int8_gemm(x.reshape(-1, k).contiguous(), w,
                    "none" if requant is None else "requant", requant=requant)
    return out.reshape(*lead, w.shape[1])


def gemm_i8_gelu(x, w, gelu_scale: float):
    """Fused ``gemm_i8 -> gelu_i8``: integer GELU of the int32 accumulator
    at a static scale, int8 out (dequant with ``gelu_out_scale``); the int32
    accumulator never leaves the kernel."""
    lead, k = x.shape[:-1], x.shape[-1]
    out = int8_gemm(x.reshape(-1, k).contiguous(), w, "requant_gelu",
                    gelu_scale=gelu_scale)
    return out.reshape(*lead, w.shape[1])


def gemm_i8_add(x, w, requant, residual):
    """Fused ``requant(gemm_i8) + residual`` with int8 saturation: the
    integer residual-stream form of an out-projection and its skip."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = w.shape[1]
    out = int8_gemm(x.reshape(-1, k).contiguous(), w, "requant_add",
                    requant=requant,
                    residual=residual.reshape(-1, n).contiguous())
    return out.reshape(*lead, n)


def gemm_w8a8(x_q, x_scale, w_q, w_scale, bias=None, residual=None,
              gelu_scale=None, out_dtype=torch.bfloat16):
    """W8A8 linear with the dequant epilogue fused into the GEMM.

    x_q [..., K] int8 with per-row scales x_scale [..., 1]; w_q [K, N] int8
    with per-column scales w_scale [N].  Returns out_dtype [..., N] — or,
    with ``gelu_scale``, the int8 GELU payload (dequant with
    ``gelu_out_scale``)."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = w_q.shape[1]
    x2 = x_q.reshape(-1, k).contiguous()
    xs2 = x_scale.reshape(-1, 1).contiguous()
    r2 = None if residual is None else residual.reshape(-1, n).contiguous()
    out = int8_gemm(x2, w_q, _epilogue(gelu_scale, r2), x_scale=xs2,
                    w_scale=w_scale, bias=bias, residual=r2,
                    gelu_scale=gelu_scale, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def _epilogue(gelu_scale, residual) -> str:
    if gelu_scale is not None:
        return "scaled_gelu"
    return "scaled" if residual is None else "scaled_add"


def gemm_w8a8_experts(x_q, x_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """The W8A8 linear of every expert of a MoE layer in one launch: x_q
    [E, M, K] int8 with row scales [E, M, 1], w_q [E, K, N] int8 with column
    scales [E, N] -> [E, M, N]."""
    return int8_gemm_experts(x_q.contiguous(), w_q, x_scale.contiguous(),
                             w_scale, out_dtype=out_dtype)


def gemm_w4a8_experts(x_q, x_scale, w4, qmul, w_scale,
                      out_dtype=torch.bfloat16):
    """The W4A8 linear of every expert in one launch: x_q [E, M, K], w4
    [E, K/2, N], qmul [E, K/g, N], w_scale [E, N] -> [E, M, N]."""
    return int4_gemm_experts(x_q.contiguous(), w4, qmul, w_scale,
                             x_scale.contiguous(), out_dtype=out_dtype)


def gated_mlp_experts(x, w_up, w_gate, act: str = "silu",
                      compute_dtype=torch.bfloat16):
    """The float gated MLP hidden of every expert in one launch: x [E, M,
    K], w_up/w_gate [E, K, N] -> [E, M, N]."""
    return dual_gemm_gated_experts(
        x.to(compute_dtype).contiguous(), w_up.to(compute_dtype),
        w_gate.to(compute_dtype), act=act)


def gated_mlp_w8a8_experts(x_q, x_scale, w_up_q, up_scale, w_gate_q,
                           gate_scale, act: str = "silu",
                           act_scale: float | None = None):
    """The W8A8 gated MLP hidden of every expert in one launch: x_q [E, M,
    K] int8 with row scales [E, M, 1], both weights [E, K, N] int8 with
    column scales [E, N] -> bf16 [E, M, N]."""
    return dual_gemm_gated_experts(x_q.contiguous(), w_up_q, w_gate_q,
                                   x_scale.contiguous(), up_scale, gate_scale,
                                   act=act, act_scale=act_scale)


def gated_mlp_w4a8_experts(x_q, x_scale, up4, up_mul, up_scale, gate4,
                           gate_mul, gate_scale, act: str = "silu",
                           act_scale: float | None = None):
    """The W4A8 gated MLP hidden of every expert in one launch: two
    packed-int4 streams [E, K/2, N] with multipliers [E, K/g, N] and scales
    [E, N] -> bf16 [E, M, N]."""
    return dual_int4_gemm_gated_experts(
        x_q.contiguous(), up4, up_mul, up_scale, gate4, gate_mul, gate_scale,
        x_scale.contiguous(), act=act, act_scale=act_scale)


def gated_mlp(x, w_up, w_gate, act: str = "silu",
              compute_dtype=torch.bfloat16):
    """Fused dual-GEMM gated MLP (float): ``act(x @ w_gate) * (x @ w_up)``
    with x read once and neither [T, d_ff] product written out."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_up.shape[1]
    out = dual_gemm_gated(x.reshape(-1, k).to(compute_dtype).contiguous(),
                          w_up.to(compute_dtype), w_gate.to(compute_dtype),
                          act=act, out_dtype=compute_dtype)
    return out.reshape(*lead, n)


def gated_mlp_w8a8(x_q, x_scale, w_up_q, up_scale, w_gate_q, gate_scale,
                   act: str = "silu", act_scale: float | None = None,
                   out_dtype=torch.bfloat16):
    """Fused W8A8 dual-GEMM gated MLP: x_q [..., K] int8 with per-row
    scales, both weights [K, N] int8 with per-column scales; dequant and the
    integer activation(gate) * up run in the GEMM epilogue."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = w_up_q.shape[1]
    out = dual_gemm_gated(x_q.reshape(-1, k).contiguous(), w_up_q, w_gate_q,
                          x_scale.reshape(-1, 1).contiguous(), up_scale,
                          gate_scale, act=act, act_scale=act_scale,
                          out_dtype=out_dtype)
    return out.reshape(*lead, n)


def gemm_w4a8(x_q, x_scale, w4, qmul, w_scale, bias=None, residual=None,
              gelu_scale=None, out_dtype=torch.bfloat16):
    """W4A8 linear: packed-int4 weights w4 [K/2, N] with group multipliers
    qmul [K/g, N] and column scales w_scale [N], nibbles unpacked in the
    kernel, the same fused epilogues as ``gemm_w8a8``."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = w4.shape[-1]
    r2 = None if residual is None else residual.reshape(-1, n).contiguous()
    out = int4_gemm(x_q.reshape(-1, k).contiguous(), w4, qmul, w_scale,
                    x_scale.reshape(-1, 1).contiguous(),
                    _epilogue(gelu_scale, r2), gelu_scale=gelu_scale,
                    bias=bias, residual=r2, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def gated_mlp_w4a8(x_q, x_scale, up4, up_mul, up_scale, gate4, gate_mul,
                   gate_scale, act: str = "silu",
                   act_scale: float | None = None, out_dtype=torch.bfloat16):
    """Fused W4A8 dual-GEMM gated MLP: two packed-int4 weight streams share
    one A tile; unpack, group dequant and the integer activation(gate) * up
    run in the kernel."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    n = up4.shape[-1]
    out = dual_int4_gemm_gated(x_q.reshape(-1, k).contiguous(), up4, up_mul,
                               up_scale, gate4, gate_mul, gate_scale,
                               x_scale.reshape(-1, 1).contiguous(), act=act,
                               act_scale=act_scale, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def layernorm_i8(x, gamma_q, beta_q, rms_only: bool = False):
    """Integer LayerNorm / RMSNorm of int payload [..., D] -> int32."""
    lead, d = x.shape[:-1], x.shape[-1]
    out = int_layernorm(x.reshape(-1, d), gamma_q, beta_q, rms_only=rms_only)
    return out.reshape(*lead, d)


def gelu_i8(x, scale: float):
    """Integer GELU of an int payload (real value x * scale): int8 out,
    dequantize with ``gelu_out_scale(scale)``."""
    return int_gelu(x, scale)


def silu_i8(x, scale: float):
    """Integer SiLU of an int payload (real value x * scale): int32 payload
    out (±127*127 range), dequantize with ``silu_out_scale(scale)``."""
    return int_silu(x, scale)


def requant(x, params):
    """int32 payload -> int8 through shift/mul16/shift (``params``:
    ``RequantParams``)."""
    return requantize_i32(x, params)


def conv2d_i8(x, w, bias, requant_params=None):
    """int8 NHWC x HWIO convolution, stride 1, VALID, + int32 bias: int32
    out, or int8 with ``requant_params``."""
    return int8_conv2d(x, w, bias, requant_params)


def softmax_mask_rows(x_shape, mask_shape) -> bool:
    """True if a mask of ``mask_shape`` has x's shape or broadcasts over
    ``x_shape``'s leading dimensions only (its last two dimensions equal
    x's, the rest are 1): its [R, N] rows then serve x's flattened row r as
    mask row r % R, uncopied.  Any other broadcast is materialized."""
    return tuple(mask_shape) == tuple(x_shape) or (
        len(x_shape) >= 2 and len(mask_shape) >= 2
        and tuple(mask_shape[-2:]) == tuple(x_shape[-2:])
        and all(d == 1 for d in mask_shape[:-2]))


def softmax_i8(x, scale: float, mask=None):
    """Integer softmax over the last axis of an int8/int32 payload [..., N]
    -> int8 probabilities (dequantize with 1/127); ``mask`` (bool, True =
    keep) gives masked positions probability 0.  A mask broadcast over
    leading dimensions only reaches the kernel uncopied
    (``softmax_mask_rows``)."""
    lead, n = x.shape[:-1], x.shape[-1]
    if mask is None:
        m2 = None
    elif softmax_mask_rows(x.shape, mask.shape):
        m2 = mask.reshape(-1, n)
    else:
        m2 = mask.expand(x.shape).reshape(-1, n)
    out = int_softmax(x.reshape(-1, n), scale, mask=m2)
    return out.reshape(*lead, n)


def attention(q, k, v, causal: bool = True, scale=None):
    """bf16 attention, q [B,H,S,D] against k/v [B,Hkv,Skv,D] (the no-cache
    forward's bf16 path)."""
    return flash_attention(q, k, v, causal=causal, scale=scale)


def attention_i8(q, k, v, scale: float, causal: bool = True, v_scale=None):
    """Integer attention (int8 QK^T -> i-softmax -> PV).  Without
    ``v_scale``: the int32 accumulator (real value acc/127 * the caller's
    per-tensor s_v).  With ``v_scale`` [B,Hkv,Skv,1] f32 per-(token, head)
    scales: V dequantized exactly in the kernel, f32 attention output."""
    return int8_flash_attention(q, k, v, scale, causal=causal, v_scale=v_scale)


def decode_attention_int8kv(q, k_q, k_s, v_q, v_s, pos_ids, qpos, scale=None,
                            window: int = 0):
    """Single-token attention over the int8 ring cache (serving hot path:
    reads the cache once as int8, dequantizes in-register)."""
    return int8_kv_decode_attention(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                    scale=scale, window=window)


def decode_attention_int8kv_rows(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                 scale=None, window: int = 0,
                                 split_hkv: int | None = None):
    """The T rows of a packed t > 1 step (q (B, T, Hq, D), qpos (B, T))
    over the int8 ring cache, each row as a single-token step at its
    position would compute it; ``split_hkv``: the kv heads the cache split
    is sized for (a TP rank's full count)."""
    return int8_kv_decode_attention_rows(q, k_q, k_s, v_q, v_s, pos_ids, qpos,
                                         scale=scale, window=window,
                                         split_hkv=split_hkv)


def paged_attention_decode_rows(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                scale=None, window: int = 0,
                                split_hkv: int | None = None):
    """The T rows of a packed t > 1 step over the PAGED KV arena, each row as
    a single-token step at its position would compute it; ``split_hkv`` as
    in ``decode_attention_int8kv_rows``."""
    return paged_decode_attention_rows(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                       scale=scale, window=window,
                                       split_hkv=split_hkv)


def paged_attention_decode(q, pk, pks, pv, pvs, ppos, pt, qpos, scale=None,
                           window: int = 0):
    """Single-token attention over the PAGED KV arena (paged serving hot
    path: pages gathered through the page table, int8 dequantized
    in-register; ``pks``/``pvs`` None = bf16 pages)."""
    return paged_decode_attention(q, pk, pks, pv, pvs, ppos, pt, qpos,
                                  scale=scale, window=window)
