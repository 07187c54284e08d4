"""Integer attention (ITA-style): int8 QK^T with int32 sums, the integer
softmax to int8 probabilities, and p @ V — with ``v_scale`` (per-(token,
head) V scales, the no-cache forward's layout) V is dequantized exactly
and the f32 attention output returned; without it the int32 accumulator.

Port of the Pallas kernel ``repro/kernels/int8_flash_attention.py:155``
``int8_flash_attention`` (three streaming passes) to the CUDA kernel
``csrc/int8_flash_attention.cu`` (source note there: bound by operations).
The kernel has two forms with the same bits: the block form keeps a block's
scores in shared memory and computes QK^T once (up to 3328 keys at head
dim 128); the streaming form, taken whenever that score block does not fit
(``streams``), runs the TPU kernel's three passes over K and takes any
number of keys.  ``LAUNCHES["int8_flash_attention.streaming"]`` counts the
launches of the streaming form among the kernel's.
``int8_flash_attention_ref`` is its plain version, ``repro.kernels.ref``'s
oracle: the integer probabilities and the int32 form are bit-exact; the f32
PV sum runs in another order, so the ``v_scale`` form agrees within
``RTOL``/``ATOL``, the reference's own (``tests/test_kernels.py``).

The kernel's constants — ``rshift`` (Python's round-half-even: D = 32 gives
2 where C's ``lround`` gives 3) and the exp's q_ln2, q_b, q_c, es — are
computed here and passed as ints.
"""
from __future__ import annotations

import math

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, cdiv, check, f32, on_cuda, rcp32
from .flash_attention import head_dim_ok
from .int_softmax import NEG_INF, _exp_consts

I32 = torch.int32
BK = 128              # keys per tile of the CUDA kernel
ROWS = 16             # query rows per block of the CUDA kernel
SMEM_LIMIT = 232448   # opt-in shared memory per block on the H100
# the v_scale form against its plain version (the reference's tolerance)
RTOL, ATOL = 1e-5, 1e-6


def head_shift(d: int) -> int:
    """The power-of-two part of 1/sqrt(d) folded into the scores."""
    return max(int(round(math.log2(math.sqrt(d)))), 0)


def _scores(q, k):
    """int8 q [B,H,S,D] . k [B,H,Skv,D] -> int32, exactly: every product
    and partial sum is an integer of magnitude <= 128*128*D < 2^24 for
    D < 1024, which f32 holds exactly (and integer matmuls do not run on
    the card)."""
    return torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()).to(I32)


def int8_attention_probs_ref(q, k, scale: float, causal: bool = True):
    """The oracle's integer probabilities [B, H, S, Skv] (int32 payload in
    [0, 127]) of ``int8_flash_attention_ref``."""
    b, h, s, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
    sc = _scores(q, k) >> head_shift(d)
    if causal:
        cmask = torch.ones((s, skv), dtype=torch.bool,
                           device=q.device).tril(skv - s)
        sc = torch.where(cmask, sc, NEG_INF)
    return inum.i_softmax(sc, scale)


def int8_flash_attention_ref(q, k, v, scale: float, causal: bool = True,
                             v_scale=None):
    b, h, s, d = q.shape
    hkv = k.shape[1]
    p = int8_attention_probs_ref(q, k, scale, causal)
    if hkv != h:
        v = v.repeat_interleave(h // hkv, dim=1)
        if v_scale is not None:
            v_scale = v_scale.repeat_interleave(h // hkv, dim=1)
    if v_scale is not None:
        vd = v.float() * v_scale                                # (B,H,Skv,D)
        out = torch.einsum("bhst,bhtd->bhsd", p.float(), vd)
        return out * f32(rcp32(127.0), out.device)
    # |sum p*v| <= 127*128*Skv: exact in f64
    return torch.einsum("bhst,bhtd->bhsd", p.double(), v.double()).to(I32)


def block_smem(skv: int, d: int) -> int:
    """Shared memory of one block of the CUDA kernel's block form: ROWS x
    Skv int32 scores (Skv padded to whole tiles), the Q rows and the K or V
    tile.  The streaming form holds one tile of scores: ``block_smem(BK, d)``."""
    skp = cdiv(skv, BK) * BK
    return ROWS * skp * 4 + ROWS * d + max(BK * (d // 4 + 1) * 4,
                                           BK * d + BK * 4)


def streams(skv: int, d: int) -> bool:
    """True if the kernel takes its streaming form: the block form's
    scores for ``skv`` keys do not fit a block's shared memory."""
    return block_smem(skv, d) > SMEM_LIMIT


def masked_exp_is_zero(scale: float, d: int) -> bool:
    """True if the oracle's exp of a causally masked score (-(2^24) - row
    max, clamped at -(2^24)) is 0 for every row max int8 inputs can give,
    so the kernel may skip key tiles above the diagonal."""
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    smax = (128 * 128 * d) >> head_shift(d)
    return ((-NEG_INF - smax) // q_ln2 >= 30
            and ((q_b * q_b + q_c) >> 30 >> es) == 0)


def _launch(q, k, v, scale, causal, v_scale, p_out):
    b, h, s, d = q.shape
    _, hkv, skv, d2 = k.shape
    check(d2 == d and tuple(v.shape) == tuple(k.shape) and h % hkv == 0
          and k.shape[0] == b, f"q {tuple(q.shape)} k {tuple(k.shape)} "
          f"v {tuple(v.shape)}")
    check(head_dim_ok(d), f"head_dim {d}: the kernel takes multiples of 16 "
          f"up to 128")
    check(skv >= 1, "no keys")
    for t in (q, k, v):
        check(t.dtype == torch.int8, f"q/k/v must be int8, got {t.dtype}")
    check(not causal or s == skv, f"causal attention needs S == Skv "
          f"(got {s}, {skv})")
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    check(q_b * q_b + q_c < 2 ** 31, f"scale {scale} too fine for int32 exp")
    check(not causal or masked_exp_is_zero(scale, d),
          f"scale {scale}: a masked score's exp is not 0")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if v_scale is not None:
        check(tuple(v_scale.shape) == (b, hkv, skv, 1)
              and v_scale.dtype == torch.float32,
              f"v_scale must be f32 {(b, hkv, skv, 1)}, got {v_scale.dtype} "
              f"{tuple(v_scale.shape)}")
        v_scale = v_scale.contiguous()
        out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((b, h, s, d), dtype=I32, device=q.device)
    if p_out is not None:
        check(tuple(p_out.shape) == (b, h, s, skv) and p_out.dtype == torch.int8
              and p_out.is_contiguous(), "p_out must be contiguous int8 "
              f"{(b, h, s, skv)}")
    streaming = streams(skv, d)
    fn = build.entry("int8_flash_attention", "repro_int8_flash_attention",
                     [build.VP] * 6 + [build.I] * 12 + [build.F, build.I,
                                                        build.VP])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(), out.data_ptr(),
            0 if p_out is None else p_out.data_ptr(), b, h, hkv, s, skv, d,
            int(causal), head_shift(d), q_ln2, q_b, q_c, es,
            float(rcp32(127.0)), int(streaming),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(rc, "int8_flash_attention")
    LAUNCHES["int8_flash_attention"] += 1
    LAUNCHES["int8_flash_attention.streaming"] += streaming
    return out


def int8_flash_attention(q, k, v, scale: float, causal: bool = True,
                         v_scale=None, p_out=None):
    """Integer attention of int8 q [B,H,S,D] against k/v [B,Hkv,Skv,D]:
    f32 [B,H,S,D] with ``v_scale`` [B,Hkv,Skv,1], else the int32
    accumulator.  The CUDA kernel for CUDA tensors (``p_out``, an int8
    [B,H,S,Skv] tensor, receives its integer probabilities), the plain
    version for CPU tensors."""
    if on_cuda(q, k, v, v_scale):
        return _launch(q, k, v, scale, causal, v_scale, p_out)
    check(p_out is None, "p_out is the CUDA kernel's debug output")
    return int8_flash_attention_ref(q, k, v, scale, causal, v_scale)
