"""Integer SiLU (the SwiGLU gate non-linearity): the I-BERT shift-exp
sigmoid times the input, on an int32 block, with a static output scale.

``silu_block`` is the in-register core that the fused gated-MLP epilogues
run (``dual_gemm_gated`` and ``dual_int4_gemm_gated`` in ``int8_gemm.py``);
its CUDA twin is ``silu_block`` in ``csrc/int_epilogue.cuh``, fed the
constants ``silu_consts`` derives.  ``int_silu`` ports the stand-alone
Pallas kernel (``repro/kernels/int_silu.py:48``) to ``csrc/int_silu.cu``
(the same block over a flat payload, bound by bytes); ``int_silu_ref`` is
its plain version.  Bit-exact on int8- and int16-range payloads (the
reference's own domain).
"""
from __future__ import annotations

import torch

from ..core import inumerics as inum
from .common import launch_elementwise, on_cuda

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


def int_silu(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Integer SiLU of an int payload of any shape (real value x * scale)
    -> int32 payload at ``silu_out_scale(scale)``: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if on_cuda(x):
        return launch_elementwise("int_silu", "int_silu", x, I32,
                                  silu_consts(scale))
    return int_silu_ref(x, scale)
