"""Chunked Mamba-2 SSD scan: x (B, T, H, P), softplus'd dt (B, T, H), the
negative per-head decay A (H,) and the per-lane B, C (B, T, N), all f32 ->
y (B, T, H, P) and the final state (B, H, N, P), from a zero state.  No
D-skip and no gating (``models/ssm.py``'s glue adds them).

Port of the Pallas kernel ``repro/kernels/ssd_scan.py:70`` ``ssd_scan`` to the
CUDA kernels ``csrc/ssd_scan.cu`` (source note there: bound by operations).
One launch runs the chunk-parallel decomposition the plain version writes
out: C.B^T once per (lane, chunk) over the causal triangle, each chunk's own
state and decay in parallel over (lane, chunk, head), the sequential pass
over the chunk states, then y = intra-chunk + inter-chunk terms in parallel
over (lane, chunk, head) — four CUDA kernels, ``ssd_scan_*``, counted as one
launch.  The wrapper allocates their scratch (``scratch_floats``: the
C.B^T tiles, every chunk's state, the chunk decays) with ``torch.empty``.
The kernels take the model's own layout — B and C indexed by lane, not
broadcast over the heads as the Pallas kernel's test does — and return the
final state as well, which the forward with states hands to its t == 1
steps.
``ssd_scan_ref`` is its plain version: the chunked form of the reference's
``repro.models.ssm._ssd_chunked``, einsum for einsum.  The two sum in other
orders and use their own ``exp``: they agree within ``RTOL``/``ATOL``, the
reference's own tolerance for its kernel (``tests/test_kernels.py``).

On the card the launch runs inside ``_SsdScan``, a
``torch.autograd.Function``: it saves its five inputs (no intermediate of
the kernel), and its backward recomputes ``ssd_scan_ref`` from them under
autograd and returns autograd's input gradients (``common.plain_grads``),
so they equal the plain version's bit for bit.  The reference has no
backward kernel either: XLA differentiates ``_ssd_chunked``.  A no-cache
training forward drops the final state, whose incoming gradient is then
None and is left out of the backward.  The recompute holds the plain
version's (B, NC, L, L, H) f32 intermediates of one layer at a time.
"""
from __future__ import annotations

import torch

from . import build
from .common import LAUNCHES, check, on_cuda, plain_grads

CHUNK = 128            # steps per chunk (the CUDA kernel's L)
SHAPES = ((64, 64), (64, 16))   # (P, N) the kernel takes: the model's, reduced
RTOL = ATOL = 3e-4
NEG = -1e30


def ssd_scan_ref(xh, dt, A, Bm, Cm, chunk: int = CHUNK):
    """The reference's ``_ssd_chunked``: intra-chunk quadratic form, per-chunk
    states, and a scan over the chunks.  T must be a multiple of ``chunk``."""
    b, t, h, p = xh.shape
    n = Bm.shape[-1]
    nc = t // chunk
    xc = xh.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = Bm.reshape(b, nc, chunk, n)
    cc = Cm.reshape(b, nc, chunk, n)
    a = dtc * A                                             # (B,NC,L,H) <= 0
    cum = torch.cumsum(a, dim=2)
    # intra-chunk: y[t] = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    dexp = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,NC,L,S,H)
    dexp = torch.where(mask[None, None, :, :, None], dexp,
                       torch.full_like(dexp, NEG))
    w = cb[..., None] * torch.exp(dexp) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bclsh,bcshp->bclhp", w, xc)
    del w, dexp
    # chunk states: h_c = sum_s exp(cum_end - cum_s) dt_s B_s x_s^T
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,NC,L,H)
    states = torch.einsum("bclh,bcln,bclhp->bchnp", dec_end * dtc, bc, xc)
    chunk_decay = torch.exp(a.sum(dim=2))                   # (B,NC,H)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):                      # emit the PREVIOUS state
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,NC,H,N,P)
    # inter-chunk contribution: y[t] += C_t exp(cum_t) H_{c-1}
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", cc, torch.exp(cum),
                           prev_states)
    return (y_intra + y_inter).reshape(b, t, h, p), state


def scratch_floats(b: int, t: int, h: int, p: int, n: int) -> dict[str, int]:
    """The f32 scratch of one launch, in the order the kernels lay it out in
    one buffer: the C.B^T tiles [B*NC, CHUNK, CHUNK], every chunk's state
    [B*NC, H, N, P] (replaced in place by the state before the chunk) and
    the chunk decays exp(cum_L) [B*NC, H]; NC = T / CHUNK."""
    nc = t // CHUNK
    return {"cbt": b * nc * CHUNK * CHUNK, "states": b * nc * h * n * p,
            "decay": b * nc * h}


def _launch(xh, dt, A, Bm, Cm):
    b, t, h, p = xh.shape
    n = Bm.shape[-1]
    check(t % CHUNK == 0 and t > 0,
          f"T={t} is not a positive multiple of the chunk {CHUNK}")
    check((p, n) in SHAPES, f"(P, N) = {(p, n)}: the kernel takes {SHAPES}")
    for x, shape in ((xh, (b, t, h, p)), (dt, (b, t, h)), (A, (h,)),
                     (Bm, (b, t, n)), (Cm, (b, t, n))):
        check(x.dtype == torch.float32 and tuple(x.shape) == shape,
              f"ssd_scan operand: want f32 {shape}, got {x.dtype} "
              f"{tuple(x.shape)}")
    xh, dt, A, Bm, Cm = (x.contiguous() for x in (xh, dt, A, Bm, Cm))
    y = torch.empty_like(xh)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=xh.device)
    scratch = torch.empty(sum(scratch_floats(b, t, h, p, n).values()),
                          dtype=torch.float32, device=xh.device)
    fn = build.entry("ssd_scan", "repro_ssd_scan",
                     [build.VP] * 8 + [build.I] * 5 + [build.VP])
    rc = fn(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            b, t, h, p, n, torch.cuda.current_stream(xh.device).cuda_stream)
    build.check_rc(rc, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state


class _SsdScan(torch.autograd.Function):
    """The scan: forward the CUDA launch, backward autograd of
    ``ssd_scan_ref`` recomputed from the saved inputs (module note)."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return _launch(xh, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate):
        return plain_grads(ssd_scan_ref, ctx.saved_tensors,
                           ctx.needs_input_grad, (dy, dstate))


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int = CHUNK):
    """-> (y (B, T, H, P), final state (B, H, N, P)), f32: the CUDA kernel
    for CUDA tensors (chunk ``CHUNK`` only; differentiable through
    ``_SsdScan``), the plain version for CPU tensors."""
    if on_cuda(xh, dt, A, Bm, Cm):
        check(chunk == CHUNK, f"the kernel's chunk is {CHUNK}, not {chunk}")
        return _SsdScan.apply(xh, dt, A, Bm, Cm)
    return ssd_scan_ref(xh, dt, A, Bm, Cm, chunk)
