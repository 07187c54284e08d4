"""The paper's six benchmark kernels (Table II) as NX-CGRA task graphs: the
port of ``repro.core.kernel_library``.

Each builder returns a ``KernelInstance`` holding (a) the phase-ordered task
graph for the static scheduler, with scalar-ISA op counts derived from the
``core.inumerics`` algorithms — field for field the reference's, (b)
functional payloads that compute the bit-exact integer result, and (c) a
float reference for validation (torch; it holds the payloads within the
reference tests' tolerances).

Input sizes and dtypes follow Table II exactly, drawn from
``np.random.default_rng(seed)`` in the reference's order, so the tensors are
the reference's:

  conv : Img int8 [3,128,128], Wgt int8 8x[3,3,3], Bias int32 [8]
  gemm : A int8 [32,64], B int8 [64,32]
  gelu : Input int8 [4,16], Weight int8 [16], Bias int32 [16]
  norm : Input int8 [64], Gamma int8 [8], Beta int8 [8]
  quant: Input int16 [64], Scale int32 [1]
  sftmx: QK_BUF int8 [32], ATTN_MASK int32 [32], BIAS int32 [32,32]

The payloads run on the builder's ``device`` (the card by default, which
raises without one; the tests pass ``"cpu"``) through the port's integer
kernels (``kernels.ops``), so on the card the paper's kernels run on the
port's own:

  gemm   per 8x8 tile ``ops.gemm_i8(..., requant=rq)`` (int8_gemm, its
         requant epilogue)
  conv   ``ops.conv2d_i8`` (int8_conv2d) in NHWC/HWIO with the requant
         params, transposed back to the reference's [C, H, W] at the edge
  gelu   the int32 product in torch, ``ops.requant`` (requantize_i32), then
         ``ops.gelu_i8`` (int_gelu: ``i_gelu_int8``)
  norm   ``ops.layernorm_i8`` (int_layernorm: ``i_layernorm`` at unit
         scales; the payload's integers do not depend on the scales), the
         output scale from the scales as the reference's
  quant  ``ops.requant`` (requantize_i32)
  sftmx  two context phases of torch ops (the environment keeps the
         reference's keys, ``_exp`` spilled between them); int_softmax
         computes the same function on these inputs, which
         ``chip_smoke.py`` phase 10 holds equal to the payload's output

The kernels return int8 where the reference's environment holds int32
payloads of int8 range: compare values.

Notes mirroring §IV-A-1:
  * sftmx exceeds the fabric -> split into two context phases with
    intermediates spilled to L1 (context_phases=2).
  * quant inputs are int16 but the PE has no 16-bit signed multiply -> the
    32-bit operator path is used (the paper's "upper bound" choice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..kernels.int_gelu import gelu_out_scale
from . import inumerics as inum
from .isa import OpClass
from .scheduler import Task

I32 = torch.int32


@dataclasses.dataclass
class KernelInstance:
    name: str
    tasks: list[Task]
    env: dict[str, Any]
    out_key: str
    out_scale: float
    useful_ops: int              # numerator of the MOPS metric (documented)
    context_phases: int = 1
    ref_fn: Callable[[dict[str, Any]], torch.Tensor] | None = None


def _ops():
    """``kernels.ops``, imported at the payload's call: the kernels'
    modules import ``core`` (its numerics) when they load."""
    from ..kernels import ops
    return ops


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _on(dev, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# ---------------------------------------------------------------------------
# gemm — A[32,64] @ B[64,32], int8 x int8 -> int32 -> requant int8
# ---------------------------------------------------------------------------

def build_gemm(seed: int = 0, m: int = 32, k: int = 64, n: int = 32,
               device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    s_a, s_b = 0.02, 0.02
    s_out = s_a * s_b * k / 8.0  # heuristic output scale
    rq = inum.compute_requant_params(s_a * s_b / s_out, acc_bound=k * 127 * 127)

    env = {"a": _on(dev, a), "b": _on(dev, b)}
    tasks: list[Task] = []
    tile = 8
    n_tiles_m, n_tiles_n = m // tile, n // tile

    def make_fn(i0, j0):
        def fn(env):
            q = _ops().gemm_i8(env["a"][i0:i0 + tile],
                               env["b"][:, j0:j0 + tile].contiguous(),
                               requant=rq)
            out = env.setdefault("out", torch.zeros((m, n), dtype=I32,
                                                    device=q.device))
            out[i0:i0 + tile, j0:j0 + tile] = q.to(I32)
        return fn

    addr = 0
    for ti in range(n_tiles_m):
        for tj in range(n_tiles_n):
            in_bytes = tile * k + k * tile           # A-rows + B-cols (int8)
            macs = tile * tile * k
            tasks.append(Task(
                name=f"gemm.t{ti}{tj}", kind="load", phase=0,
                nbytes=in_bytes, addr=addr))
            tasks.append(Task(
                name=f"gemm.c{ti}{tj}", kind="compute", phase=0,
                ops={
                    OpClass.MAC8: macs,
                    # per-4-MAC inner-loop control + accumulate staging
                    OpClass.ALU32: macs // 4 + tile * tile * 3,  # + requant
                    OpClass.MUL16: tile * tile,                   # requant mult
                },
                in_bytes=in_bytes, out_bytes=tile * tile,
                fn=make_fn(ti * tile, tj * tile)))
            tasks.append(Task(
                name=f"gemm.s{ti}{tj}", kind="store", phase=0,
                nbytes=tile * tile, addr=addr + 1 << 12))
            addr += in_bytes

    def ref(env):
        return env["a"].double() @ env["b"].double()

    return KernelInstance(
        name="gemm", tasks=tasks, env=env, out_key="out", out_scale=s_out,
        useful_ops=2 * m * k * n, ref_fn=ref)


# ---------------------------------------------------------------------------
# conv — 2D convolution, Img[3,128,128] * 8 x Wgt[3,3,3] + Bias[8]
# ---------------------------------------------------------------------------

def _conv_acc(img, wgt, bias):
    """The exact int32 accumulator [O, OH, OW] + bias of the VALID conv of
    img [C, H, W] with wgt [O, C, KH, KW]: f64 products and sums of int8
    values (27 a pixel) are exact in any order."""
    acc = torch.nn.functional.conv2d(img.double()[None], wgt.double())[0]
    return acc + bias.double()[:, None, None]


def build_conv(seed: int = 1, device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    cin, h, w = 3, 128, 128
    cout, kh, kw = 8, 3, 3
    oh, ow = h - kh + 1, w - kw + 1
    img = rng.integers(-127, 128, size=(cin, h, w)).astype(np.int8)
    wgt = rng.integers(-127, 128, size=(cout, cin, kh, kw)).astype(np.int8)
    bias = rng.integers(-(2 ** 15), 2 ** 15, size=(cout,)).astype(np.int32)
    env = {"img": _on(dev, img), "wgt": _on(dev, wgt), "bias": _on(dev, bias)}
    macs_per_px = cin * kh * kw  # 27
    rq = inum.compute_requant_params(1e-4, acc_bound=macs_per_px * 127 * 127 + 2 ** 15)

    def fn(env):
        # the reference's NCHW image and OIHW weight as int8_conv2d's NHWC
        # and HWIO, its [1, OH, OW, O] output back to [O, OH, OW]
        x = env["img"].permute(1, 2, 0)[None].contiguous()
        wt = env["wgt"].permute(2, 3, 1, 0).contiguous()
        out = _ops().conv2d_i8(x, wt, env["bias"], requant_params=rq)
        env["out"] = out[0].permute(2, 0, 1).to(I32).contiguous()

    tasks: list[Task] = []
    addr = 0
    # one task per (filter, output-row): realistic strip-mined mapping
    for f in range(cout):
        for r in range(oh):
            in_bytes = kh * w * (1 if f else cin)  # window rows; weights resident
            tasks.append(Task(name=f"conv.l{f}.{r}", kind="load", phase=0,
                              nbytes=in_bytes, addr=addr))
            tasks.append(Task(
                name=f"conv.c{f}.{r}", kind="compute", phase=0,
                ops={
                    # the 3-wide sliding window cannot fill the 4-lane fused
                    # MAC: each of the 27 window MACs is its own issue
                    OpClass.MAC8: ow * macs_per_px * 4,
                    OpClass.ALU32: ow * 8,   # window pointer bumps + bias + requant
                    OpClass.MUL16: ow,       # requant multiply
                },
                in_bytes=in_bytes, out_bytes=ow,
                fn=fn if (f == 0 and r == 0) else None))
            tasks.append(Task(name=f"conv.s{f}.{r}", kind="store", phase=0,
                              nbytes=ow, addr=addr + (1 << 14)))
            addr += in_bytes

    def ref(env):
        return _conv_acc(env["img"], env["wgt"], env["bias"])

    return KernelInstance(
        name="conv", tasks=tasks, env=env, out_key="out", out_scale=1e-4,
        useful_ops=2 * cout * oh * ow * macs_per_px, ref_fn=ref)


# ---------------------------------------------------------------------------
# gelu — fused scale+bias+GELU, Input[4,16] (x*w + b then GELU)
# ---------------------------------------------------------------------------

def build_gelu(seed: int = 2, device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    x = rng.integers(-127, 128, size=(4, 16)).astype(np.int8)
    wgt = rng.integers(1, 127, size=(16,)).astype(np.int8)
    bias = rng.integers(-(2 ** 10), 2 ** 10, size=(16,)).astype(np.int32)
    s_x = 0.04
    env = {"x": _on(dev, x), "w": _on(dev, wgt), "b": _on(dev, bias)}
    # pre-activation scale: (x*w+b) at scale s_x/64 (w treated as fixed-point /64)
    s_pre = s_x / 64.0
    # requantize the int32 pre-activation to int8 before the GELU — the
    # fabric's quant->gelu kernel chain (i_gelu operates on int8 payloads)
    acc_bound = 127 * 127 + 2 ** 10
    s8 = acc_bound * s_pre / 127.0
    rq_pre = inum.compute_requant_params(s_pre / s8, acc_bound)

    def fn(env):
        pre = env["x"].to(I32) * env["w"].to(I32) + env["b"]
        q8 = _ops().requant(pre, rq_pre)
        env["out"] = _ops().gelu_i8(q8, s8).to(I32)
        env["out_scale"] = gelu_out_scale(s8)

    n_elem = 4 * 16
    # per-element scalar ops from the i_gelu formula:
    #   erf poly: abs,min,add,sq(mul),add,sign-mul  = 4 alu + 2 mul
    #   gelu: add q_one, x*erf (mul), requant (shift,mul16,shift,clip)
    # the mapper spreads the 64 elements over 8 PEs (chunks of 8)
    tasks: list[Task] = []
    n_chunks, chunk = 8, n_elem // 8
    for c in range(n_chunks):
        cb = chunk + 2 + 8  # chunk + weight/bias slice bytes
        tasks.append(Task(name=f"gelu.l{c}", kind="load", phase=0, nbytes=cb, addr=c * 64))
        tasks.append(Task(
            name=f"gelu.c{c}", kind="compute", phase=0,
            ops={
                OpClass.ALU32: chunk * 9,
                OpClass.MUL32: chunk * 3,
                OpClass.MUL16: chunk * 2,
            },
            in_bytes=cb, out_bytes=chunk, fn=fn if c == 0 else None))
        tasks.append(Task(name=f"gelu.s{c}", kind="store", phase=0, nbytes=chunk,
                          addr=(1 << 13) + c * 64))

    def ref(env):
        # the exact (erf) GELU of the float pre-activation
        pre = ((env["x"].to(I32) * env["w"].to(I32) + env["b"]).double()
               * s_pre).float()
        return torch.nn.functional.gelu(pre)

    return KernelInstance(
        name="gelu", tasks=tasks, env=env, out_key="out", out_scale=0.0,
        useful_ops=n_elem * 14, ref_fn=ref)


# ---------------------------------------------------------------------------
# norm — LayerNorm over 64 elements, grouped gamma/beta[8]
# ---------------------------------------------------------------------------

def build_norm(seed: int = 3, device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    d = 64
    x = rng.integers(-127, 128, size=(d,)).astype(np.int8)
    gamma = rng.integers(32, 127, size=(8,)).astype(np.int8)
    beta = rng.integers(-64, 64, size=(8,)).astype(np.int8)
    s_x, s_gb = 0.05, 1.0 / 64.0
    env = {"x": _on(dev, x), "gamma": _on(dev, gamma), "beta": _on(dev, beta)}

    def fn(env):
        g = torch.repeat_interleave(env["gamma"].to(I32), d // 8)
        b = torch.repeat_interleave(env["beta"].to(I32), d // 8)
        env["out"] = _ops().layernorm_i8(env["x"].to(I32), g, b)
        # i_layernorm's output scale (its integers do not depend on s_x)
        env["out_scale"] = s_gb / float(1 << 7)

    # three schedule phases: parallel partial sums -> combine + Newton sqrt
    # (serial, div-latency bound) -> parallel normalize (one div per element).
    # Explains the paper's 70 MOPS for norm vs 3040 for gemm.
    tasks: list[Task] = []
    n_par, chunk = 4, d // 4
    for c in range(n_par):
        tasks.append(Task(name=f"norm.l{c}", kind="load", phase=0,
                          nbytes=chunk + 4, addr=c * 64))
        tasks.append(Task(
            name=f"norm.red{c}", kind="compute", phase=0,
            ops={OpClass.ALU32: chunk * 3, OpClass.MUL32: chunk},  # sum, sumsq
            in_bytes=chunk + 4, out_bytes=8))
    tasks.append(Task(
        name="norm.sqrt", kind="compute", phase=1,
        ops={OpClass.ALU32: 40, OpClass.DIV32: 10},  # combine + Newton isqrt
        in_bytes=8 * n_par, out_bytes=8, fn=fn))
    for c in range(n_par):
        tasks.append(Task(
            name=f"norm.nrm{c}", kind="compute", phase=2,
            ops={
                OpClass.ALU32: chunk * 2,
                OpClass.DIV32: chunk,        # per-element /std
                OpClass.MUL16: chunk,        # gamma multiply
            },
            in_bytes=chunk + 8, out_bytes=chunk * 2))
        tasks.append(Task(name=f"norm.s{c}", kind="store", phase=2,
                          nbytes=chunk * 2, addr=(1 << 13) + c * 64))

    def ref(env):
        xf = env["x"].float() * s_x
        mu, sd = xf.mean(), xf.std(unbiased=False) + 1e-6
        g = torch.repeat_interleave(env["gamma"].float() * s_gb, d // 8)
        b = torch.repeat_interleave(env["beta"].float() * s_gb, d // 8)
        return (xf - mu) / sd * g + b

    return KernelInstance(
        name="norm", tasks=tasks, env=env, out_key="out", out_scale=s_gb / 128,
        useful_ops=d * 7, ref_fn=ref)


# ---------------------------------------------------------------------------
# quant — requantize int16 -> int8 with int32 scale (32-bit operator path)
# ---------------------------------------------------------------------------

def build_quant(seed: int = 4, device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    d = 64
    x = rng.integers(-(2 ** 15), 2 ** 15, size=(d,)).astype(np.int16)
    env = {"x": _on(dev, x.astype(np.int32))}
    rq = inum.compute_requant_params(127.0 / 2 ** 15, acc_bound=2 ** 15)

    def fn(env):
        env["out"] = _ops().requant(env["x"], rq).to(I32)

    # mapped onto 2 PEs (tiny kernel; matches the paper's low quant MOPS)
    tasks: list[Task] = []
    for c in range(2):
        h = d // 2
        tasks.append(Task(name=f"quant.l{c}", kind="load", phase=0,
                          nbytes=h * 2 + 4, addr=c * 128))
        tasks.append(Task(
            name=f"quant.c{c}", kind="compute", phase=0,
            # int16 data on the 32-bit path (paper §IV-A-1): shift, clip x2,
            # 16-bit multiply, shift, pack
            ops={OpClass.ALU32: h * 5, OpClass.MUL16: h},
            in_bytes=h * 2 + 4, out_bytes=h, fn=fn if c == 0 else None))
        tasks.append(Task(name=f"quant.s{c}", kind="store", phase=0, nbytes=h,
                          addr=(1 << 13) + c * 64))

    def ref(env):
        return torch.clamp(torch.round(env["x"].double() * (127.0 / 2 ** 15)),
                           -128, 127)

    return KernelInstance(
        name="quant", tasks=tasks, env=env, out_key="out", out_scale=2 ** 15 / 127.0 / 2 ** 15,
        useful_ops=d * 4, ref_fn=ref)


# ---------------------------------------------------------------------------
# sftmx — masked softmax over 32x32 scores (two context phases, §IV-A-1)
# ---------------------------------------------------------------------------

SFTMX_SCALE = 0.08


def build_sftmx(seed: int = 5, device=None) -> KernelInstance:
    dev = resolve_device(device)
    rng = _rng(seed)
    rows, cols = 32, 32
    scores = rng.integers(-127, 128, size=(rows, cols)).astype(np.int8)
    mask = (rng.random((rows, cols)) > 0.1)
    s_x = SFTMX_SCALE
    env = {"scores": _on(dev, scores), "mask": _on(dev, mask)}

    def fn_phase1(env):
        q = env["scores"].to(I32)
        q = torch.where(env["mask"], q, -(2 ** 24))
        q_max = torch.amax(q, dim=-1, keepdim=True)
        q_exp, s_exp = inum.i_exp(q - q_max, s_x)
        q_exp = torch.where(env["mask"], q_exp, 0)
        env["_exp"] = q_exp  # intermediate spilled to L1 (context switch)

    def fn_phase2(env):
        q_exp = env["_exp"]
        q_sum = torch.clamp(q_exp.sum(-1, keepdim=True, dtype=I32), min=1)
        out = torch.clamp((q_exp * 127 + (q_sum >> 1)) // q_sum, 0, 127)
        env["out"] = out

    n = rows * cols
    # row-parallel mapping: 2 rows per PE, both phases (the paper splits this
    # kernel across two contexts because it exceeds the fabric, §IV-A-1)
    tasks: list[Task] = []
    rows_per_task = 2
    for c in range(rows // rows_per_task):
        rn = rows_per_task * cols           # elements in this slice
        ib = rn + 4 * rn                    # scores int8 + mask int32
        tasks.append(Task(name=f"sftmx.l0.{c}", kind="load", phase=0,
                          nbytes=ib, addr=c * 256))
        tasks.append(Task(
            name=f"sftmx.exp{c}", kind="compute", phase=0,
            ops={
                OpClass.ALU32: rn * 6 + rows_per_task * (cols - 1),  # mask,max,shift-exp
                OpClass.MUL32: rn,                                    # poly square
            },
            in_bytes=ib, out_bytes=4 * rn, fn=fn_phase1 if c == 0 else None))
        tasks.append(Task(name=f"sftmx.sp{c}", kind="store", phase=0,
                          nbytes=4 * rn, addr=(1 << 14) + c * 256))
        # phase 1 runs in a fresh context: reload intermediates, reduce, divide
        tasks.append(Task(name=f"sftmx.l1.{c}", kind="load", phase=1,
                          nbytes=4 * rn, addr=(1 << 14) + c * 256))
        tasks.append(Task(
            name=f"sftmx.div{c}", kind="compute", phase=1,
            ops={
                OpClass.ALU32: rn * 2 + rows_per_task * (cols - 1),  # sums + rounding
                OpClass.DIV32: rn,                                    # normalize
            },
            in_bytes=4 * rn, out_bytes=rn, fn=fn_phase2 if c == 0 else None))
        tasks.append(Task(name=f"sftmx.s{c}", kind="store", phase=1,
                          nbytes=rn, addr=(1 << 15) + c * 64))

    def ref(env):
        xf = env["scores"].float() * s_x
        xf = torch.where(env["mask"], xf, -torch.inf)
        e = torch.exp(xf - xf.amax(-1, keepdim=True))
        e = torch.where(env["mask"], e, 0.0)
        return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-9)

    return KernelInstance(
        name="sftmx", tasks=tasks, env=env, out_key="out",
        out_scale=inum.SOFTMAX_OUT_SCALE, useful_ops=n * 10,
        context_phases=2, ref_fn=ref)


BUILDERS = {
    "conv": build_conv,
    "gemm": build_gemm,
    "gelu": build_gelu,
    "norm": build_norm,
    "quant": build_quant,
    "sftmx": build_sftmx,
}
