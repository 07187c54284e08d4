"""Tensor-parallel SERVING: exactness-preserving TP boundaries.

Port of ``repro.dist.tp``.  The reference shards its packed step with
``shard_map`` over a ("tp",) mesh; the port runs SPMD over
``torch.distributed``: one process per rank, every rank running the same
engine loop on the same requests, each holding its shard of the weights and
of the KV payloads (``dist/sharding.py``).  The exactness rule is the
reference's: the sharded step NEVER sums partial products across ranks, so
its tokens are bit-identical to tp = 1.

  * QKV and MLP up/gate projections are COLUMN-sharded (the full
    contraction dim on every rank: each output element is computed as on
    one device, there are just fewer of them per rank);
  * attention is HEAD-sharded (a head's softmax and PV never see another
    head), with the KV cache / paged arena sharded on the Hkv axis so page
    payloads stay local to their head shard;
  * the row GEMMs (``wo``, ``w_out``) keep their FULL weights replicated and
    run AFTER a collective that rebuilds full rows:

      barrier:  all-gather the feature-sharded hidden, then every rank runs
                the full GEMM (redundant compute, zero risk);
      overlap:  all-to-all the hidden from feature-sharded to TOKEN-sharded
                and run the GEMM (with its fused epilogue) on 1/tp of the
                rows (the full contraction dim: still exact).  The output
                STAYS row-sharded (sequence parallel): the residual stream
                between boundaries is each rank's row block, the next norm
                runs on those local rows, and ``tp_row_unshard`` gathers
                full rows only in front of the next full-row consumer (QKV,
                MLP-in, the head).  Pad rows (rows % tp != 0) sit at the
                tail of the last rank's block; every op on the stream is
                per-row, so they never touch a real row.

Per-row activation quantization (``ops.quant_rows``, the fused norm's
quantized rows) and per-(token, head) KV quantization make both the token
split and the head split exact for the integer paths too.  There is NO
all-reduce and NO reduce-scatter in the sharded step: every collective goes
through ``_collective``, which knows only all-gather and all-to-all and
counts each call in ``COLLECTIVES``.

The context is installed around the forward (``with tp_serving(ctx):``);
model code consults it through ``tp_serving_ctx()`` and every helper is the
identity outside a context and at size 1, so the tp = 1 path is the
single-device program.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# collectives run by ``_collective``, by kind ("all_gather", "all_to_all")
COLLECTIVES: collections.Counter = collections.Counter()


class TPConfigError(ValueError):
    """Typed rejection of a (cfg, tp) pair the exact TP path cannot shard."""


@dataclasses.dataclass(frozen=True)
class TPServing:
    """An active tensor-parallel serving region: the ranks' process group
    (None: the default group), its size, this process's rank in it, and the
    row-GEMM boundary (all-to-all + token-sharded row GEMM vs barrier)."""

    group: Any = None
    size: int = 1
    rank: int = 0
    overlap: bool = False


_CTX: list[TPServing | None] = [None]


def tp_serving_ctx() -> TPServing | None:
    return _CTX[0]


@contextlib.contextmanager
def tp_serving(ctx: TPServing | None):
    """Install ``ctx`` (None: no TP region) for the duration of the block;
    the previous context comes back on exit, an error included."""
    prev = _CTX[0]
    _CTX[0] = ctx
    try:
        yield
    finally:
        _CTX[0] = prev


# serving blocks the exact TP path knows how to shard: plain/windowed
# attention + MLP.  MoE (expert dispatch), recurrent state (Mamba/xLSTM)
# and cross-attention/encoder-decoder states are rejected up front with a
# typed error.
_TP_BLOCKS = {"attn", "attn_swa", "shared_attn"}


def validate_tp_serving(cfg, tp: int, *, kv_source=None) -> None:
    """Reject (cfg, tp) pairs the exactness-preserving layout cannot split.

    Head sharding needs n_heads AND n_kv_heads divisible by tp (a partial
    split would misalign GQA groups across ranks); the column-sharded MLP
    needs d_ff divisible by tp.  No silent demotion: serving TP either
    shards the layout it promised or refuses loudly."""
    if tp <= 1:
        return
    bad = sorted(set(cfg.block_pattern) - _TP_BLOCKS)
    if bad or kv_source is not None:
        what = "cross-attention kv_source" if kv_source is not None else \
            f"block kinds {bad}"
        raise TPConfigError(
            f"serving TP (tp={tp}) supports plain/windowed attention + MLP "
            f"archs only; {cfg.name} has {what}")
    for dim_name, dim in (("n_heads", cfg.n_heads),
                          ("n_kv_heads", cfg.n_kv_heads),
                          ("d_ff", cfg.d_ff)):
        if dim % tp:
            raise TPConfigError(
                f"serving TP requires {dim_name} % tp == 0 (head/column "
                f"sharding is exact only for whole heads/columns): "
                f"{cfg.name} has {dim_name}={dim}, tp={tp}")


def _collective(ctx: TPServing, op: str, x: torch.Tensor) -> torch.Tensor:
    """The one transport of the sharded step.  ``all_gather``: returns (tp,
    *x.shape), entry i rank i's ``x``.  ``all_to_all``: x's rows split in
    tp equal blocks, block j sent to rank j; returns (tp, rows / tp, ...),
    entry i the block rank i sent here.  Tensors travel as their bytes, so
    every dtype passes bit for bit.

    Gloo has no all-gather or all-to-all of CUDA tensors, and NCCL refuses
    two ranks on one card: with the gloo backend a CUDA tensor is STAGED —
    copied to a host buffer, exchanged, copied back to the card (each copy
    waits for the device) — and the all-to-all is its tp - 1 pairwise
    exchanges (gloo's own all-to-all is missing from some builds).  NCCL
    (one card a rank) exchanges on the card."""
    COLLECTIVES[op] += 1
    dev, dtype = x.device, x.dtype
    raw = x.contiguous().view(torch.uint8)
    gloo = dist.get_backend(ctx.group) == "gloo"
    stage = gloo and dev.type == "cuda"
    if stage:
        raw = raw.cpu()
    if op == "all_gather":
        out = raw.new_empty((ctx.size, *raw.shape))
        dist.all_gather(list(out.unbind(0)), raw, group=ctx.group)
    elif op == "all_to_all":
        out = raw.new_empty((ctx.size, raw.shape[0] // ctx.size,
                             *raw.shape[1:]))
        sends, recvs = list(raw.chunk(ctx.size)), list(out.unbind(0))
        if gloo:
            _pairwise(ctx, sends, recvs)
        else:
            dist.all_to_all(recvs, sends, group=ctx.group)
    else:
        raise ValueError(f"the sharded step moves data only (all_gather, "
                         f"all_to_all), not {op!r}")
    if stage:
        out = out.to(dev)
    return out.view(dtype)


def _pairwise(ctx: TPServing, sends: list, recvs: list) -> None:
    """All-to-all as point-to-point exchanges: ``sends[j]`` to rank j and
    ``recvs[j]`` from rank j, this rank's own block copied in place."""
    peer = (lambda j: j) if ctx.group is None else (
        lambda j: dist.get_global_rank(ctx.group, j))
    work = []
    for j in range(ctx.size):
        if j == ctx.rank:
            recvs[j].copy_(sends[j])
            continue
        work.append(dist.isend(sends[j], peer(j), group=ctx.group))
        work.append(dist.irecv(recvs[j], peer(j), group=ctx.group))
    for w in work:
        w.wait()


def agree(n: int, ctx: TPServing | None, device) -> int:
    """Rank 0's ``n`` on every rank of ``ctx`` (an all-gather of one
    integer on ``device``, the rank's own: NCCL moves only tensors on the
    card; ``n`` itself without a context or at size 1): a host decision
    that reads the clock — ``run_stream``'s arrivals — is taken once for
    all ranks, so their schedules, and the shapes of their collectives,
    stay equal."""
    if ctx is None or ctx.size <= 1:
        return n
    x = torch.tensor([n], device=device)
    return int(_collective(ctx, "all_gather", x)[0, 0])


def _active(overlap_only: bool) -> TPServing | None:
    ctx = _CTX[0]
    if ctx is None or ctx.size <= 1 or (overlap_only and not ctx.overlap):
        return None
    return ctx


def _row_block(ctx: TPServing, rows: int) -> int:
    """Rows per rank when the residual stream is sequence-parallel (padded
    up so every rank carries the same block)."""
    return -(-rows // ctx.size)


def _pad_rows(ctx: TPServing, x: torch.Tensor) -> torch.Tensor:
    """(B, T, F) -> (tp * r_loc, F), zero rows appended at the tail."""
    rows = x.shape[0] * x.shape[1]
    xr = x.reshape(rows, x.shape[-1])
    pad = _row_block(ctx, rows) * ctx.size - rows
    return xr if pad == 0 else torch.cat([xr, xr.new_zeros(pad, xr.shape[1])])


def tp_row_shard(x: torch.Tensor) -> torch.Tensor:
    """SP entry: replicated rows (B, T, D) -> this rank's row block (1,
    r_loc, D).  Identity outside an overlap TP region."""
    ctx = _active(overlap_only=True)
    if ctx is None:
        return x
    xr = _pad_rows(ctx, x)
    r_loc = xr.shape[0] // ctx.size
    return xr[ctx.rank * r_loc:(ctx.rank + 1) * r_loc][None]


def tp_row_unshard(h, b: int, t: int):
    """SP exit: gather the row blocks back to replicated (b, t, ...) in front
    of a full-row consumer (QKV / MLP-in / the head).  ``h`` is a tensor
    (1, r_loc, F) or a tuple of them — a norm's output with its quantized
    rows and scales (a ``QRows``), None entries passing through — gathered
    in ONE collective of their bytes.  Identity outside an overlap TP
    region: callers invoke it unconditionally."""
    ctx = _active(overlap_only=True)
    if ctx is None:
        return h
    parts = [h] if torch.is_tensor(h) else list(h)
    live = [p for p in parts if p is not None]
    raw = torch.cat([p.reshape(p.shape[1], -1).contiguous().view(torch.uint8)
                     for p in live], dim=1)
    got = _collective(ctx, "all_gather", raw)
    got = got.reshape(-1, raw.shape[1])[:b * t]
    out, col = [], 0
    for p in parts:
        if p is None:
            out.append(None)
            continue
        n = p[0].numel() // p.shape[1] * p.element_size()
        out.append(got[:, col:col + n].contiguous().view(p.dtype)
                   .reshape(b, t, *p.shape[2:]))
        col += n
    if torch.is_tensor(h):
        return out[0]
    return type(h)(*out) if hasattr(h, "_fields") else tuple(out)


def tp_out_projection(h: torch.Tensor, residual, apply_out):
    """The TP boundary in front of a row GEMM (``wo`` / ``w_out``).

    ``h`` is the feature-sharded hidden (B, T, F/tp); ``apply_out(h_full,
    residual)`` runs the projection (with its fused epilogue) on rows
    carrying the FULL feature dim.  Outside a TP region this is exactly
    ``apply_out(h, residual)``.

    Barrier: all-gather on the feature dim, the full-row GEMM on every rank
    (output replicated).  Overlap: all-to-all the (B*T, F/tp) rows from
    feature-sharded to token-sharded — rank d ends up with rows [d*r_loc,
    (d+1)*r_loc) carrying full features — and the GEMM on those rows.  The
    result is returned ROW-SHARDED (1, r_loc, D), and ``residual`` arrives
    as the caller's row block."""
    ctx = _active(overlap_only=False)
    if ctx is None:
        return apply_out(h, residual)
    if not ctx.overlap:
        g = _collective(ctx, "all_gather", h)             # (tp, B, T, F/tp)
        return apply_out(g.movedim(0, -2).reshape(*h.shape[:-1], -1),
                         residual)
    # the peers' blocks arrive in feature-shard order: concatenating them
    # assembles each row's full feature dim
    g = _collective(ctx, "all_to_all", _pad_rows(ctx, h))  # (tp, r_loc, F/tp)
    return apply_out(g.movedim(0, 1).reshape(1, g.shape[1], -1), residual)
