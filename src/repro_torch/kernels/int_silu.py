"""Integer SiLU (the SwiGLU gate non-linearity): the I-BERT shift-exp
sigmoid times the input, on an int32 block, with a static output scale.

``silu_block`` is the in-register core that the fused gated-MLP epilogues
run (``dual_gemm_gated`` and ``dual_int4_gemm_gated`` in ``int8_gemm.py``);
its CUDA twin is ``silu_block`` in ``csrc/int_epilogue.cuh``, fed the
constants ``silu_consts`` derives.  The stand-alone ``int_silu`` Pallas
kernel (``repro/kernels/int_silu.py:48``) is not on the ported path and is
not launched by the port yet (ROADMAP.md §B10).
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum

I32 = torch.int32


def silu_out_scale(scale: float) -> float:
    """Dequant scale of the int32 SiLU payload (``i_silu``'s scale/127)."""
    return scale / 127.0


def silu_consts(scale: float) -> tuple[int, int, int, int]:
    """(q_ln2, q_b, q_c, q_one): the static integers the CUDA
    ``silu_block`` takes for activation scale ``scale``."""
    q_ln2, q_b, q_c, _ = inum.exp_consts(scale)
    return q_ln2, q_b, q_c, inum.sigmoid_one(scale)


def silu_block(q: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Integer SiLU of one int32 block -> int32 payload (|out| <= 127*128)."""
    payload, _ = inum.i_silu(q, scale)
    return payload


def int_silu_ref(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain integer SiLU (``ref.int_silu_ref``): int payload -> int32."""
    return silu_block(x.to(I32), scale=scale)
