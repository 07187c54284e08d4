"""Integer attention (ITA-style): int8 QK^T with int32 sums, the integer
softmax to int8 probabilities, and p @ V — with ``v_scale`` (per-(token,
head) V scales, the no-cache forward's layout) V is dequantized exactly
and the f32 attention output returned; without it the int32 accumulator.

Port of the Pallas kernel ``repro/kernels/int8_flash_attention.py:155``
``int8_flash_attention`` (three streaming passes) to the CUDA kernel
``csrc/int8_flash_attention.cu`` (source note there: bound by operations,
the v_scale form's f32 PV).  The kernel has one form, for any number of
keys: blocks of 64 query rows stream K three times, as the TPU kernel does
— a first CUDA kernel each row's max and exp-sum (into ``stats``, scratch
from ``torch.empty``), a second the probabilities and PV — QK^T on the int8
tensor cores, K and V through a ``cp.async`` ring, the softmax's two
divisions as multiply-highs by exact reciprocals (``common.rcp``), PV on int8
tensor cores (int32 form) or a register-blocked f32 product over the keys
with a nonzero probability (v_scale form).  One call counts as one launch.
Every launch streams (``streams``);
``LAUNCHES["int8_flash_attention.streaming"]`` counts them as it counted
the streaming form's before the block form was retired.
``int8_flash_attention_ref`` is its plain version, ``repro.kernels.ref``'s
oracle: the integer probabilities and the int32 form are bit-exact; the f32
PV sum runs in another order, so the ``v_scale`` form agrees within
``RTOL``/``ATOL``, the reference's own (``tests/test_kernels.py``).

The kernel's constants — ``rshift`` (Python's round-half-even: D = 32 gives
2 where C's ``lround`` gives 3), the exp's q_ln2, q_b, q_c, es and q_ln2's
reciprocal — are computed here and passed as ints; the wrapper checks the
ranges in which the reciprocals are exact (``sums_fit``).
"""
from __future__ import annotations

import math

import torch

from ..core import inumerics as inum
from . import build
from .common import LAUNCHES, cdiv, check, f32, on_cuda, rcp, rcp32
from .flash_attention import head_dim_ok
from .int_softmax import NEG_INF, _exp_consts, exp_max, sums_fit

I32 = torch.int32
BK = 64               # keys per tile of the CUDA kernel
ROWS = 64             # query rows per block of the CUDA kernel (4 warps x 16)
STAGES = 3            # stages of its cp.async ring
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


def block_smem(skv: int, d: int, v_scale: bool = True) -> int:
    """Shared memory of one block of the CUDA kernel (``Lay`` in the
    source), the same at any number of keys ``skv``: a ring of STAGES
    stages, each a K tile (rows zero-padded to whole 32-byte k steps) and a
    V tile of BK keys (every row padded to an odd count of 16-byte chunks)
    and BK V scales; with ``v_scale`` also the dequantized f32 V tile and
    the f32 probabilities [BK][20] of each 16 rows and, per 8 rows, two
    32-bit masks of the keys with a nonzero probability."""
    del skv
    dp = cdiv(d, 32) * 32
    ldk, ldv = dp + 16, d + (16 if (d // 16) % 2 == 0 else 0)
    ring = STAGES * (BK * ldk + BK * ldv + BK * 4)
    return ring + ((BK * d * 4 + 4 * BK * 20 * 4 + 8 * 2 * 4) if v_scale
                   else 0)


def streams(skv: int, d: int) -> bool:
    """True if the kernel streams K for ``skv`` keys at head dim ``d``: its
    one form streams K three times at every key count it takes (any
    ``skv`` >= 1 whose block fits shared memory, which does not depend on
    ``skv``)."""
    return skv >= 1 and block_smem(skv, d) <= SMEM_LIMIT


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
    check(sums_fit(skv, scale), f"scale {scale}, {skv} keys: the softmax's "
          f"sums leave the range of its exact reciprocals")
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
    ln2_m, ln2_sh = rcp(q_ln2)
    # each row's max and exp-sum, from the first kernel to the second
    stats = torch.empty((b, h, s, 2), dtype=I32, device=q.device)
    fn = build.entry("int8_flash_attention", "repro_int8_flash_attention",
                     [build.VP] * 6 + [build.I] * 12 + [build.U, build.I,
                                                        build.F, build.VP,
                                                        build.VP])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(), out.data_ptr(),
            0 if p_out is None else p_out.data_ptr(), b, h, hkv, s, skv, d,
            int(causal), head_shift(d), q_ln2, q_b, q_c, es, ln2_m, ln2_sh,
            float(rcp32(127.0)), stats.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_rc(rc, "int8_flash_attention")
    LAUNCHES["int8_flash_attention"] += 1
    LAUNCHES["int8_flash_attention.streaming"] += 1
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
