"""Input specs and sharding plans for every (arch x shape x mesh) cell.

Port of ``repro.launch.specs``: arithmetic on the config.  ``make_cell_plan``
binds the logical model axes to the mesh with the reference's per-arch
decisions, reading only ``mesh.shape`` and ``mesh_axis_size``:

  * heads-vs-sequence KV sharding: KV heads shard on "model" only when
    divisible (n_kv % tp == 0); otherwise the cache shards its SEQUENCE dim
    on "model";
  * EP-vs-TP MoE: experts shard on "model" when n_experts % tp == 0,
    otherwise each expert's hidden dim shards;
  * batch-1 long-context cells replicate the batch and shard the KV
    sequence over both the data and the model axes.

``abstract_params`` and ``abstract_states`` are the port's trees on
``device="meta"`` (shapes and dtypes, no data: the reference's
``jax.eval_shape``), ``input_specs`` the meta tensors of a cell's step
inputs, and ``state_specs`` the specs of the state tree in the reference's
layout (each block-pattern position's leaves stacked over the periods).
"""
from __future__ import annotations

import dataclasses

import torch

from ..convert import LeafShape
from ..dist.sharding import AxisEnv, map_with_path
from ..models import init_encdec_params, init_params, init_states
from ..models.config import ArchConfig
from .mesh import mesh_axis_size

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """Resolved distribution strategy for one (arch, shape, mesh) cell."""

    env: AxisEnv
    kv_heads_on_model: bool
    ep_mode: bool                  # experts on model axis?
    batch_axes: tuple[str, ...]    # mesh axes sharding the batch dim
    seq_axes_kv: tuple[str, ...]   # mesh axes sharding the KV sequence dim


def make_cell_plan(cfg: ArchConfig, mesh, kind: str, global_batch: int,
                   fsdp: bool = True,
                   variant: str = "baseline") -> CellPlan:
    tp = mesh_axis_size(mesh, "model")
    pod = mesh_axis_size(mesh, "pod")
    data = mesh_axis_size(mesh, "data")
    batch_axes: tuple[str, ...] = ()
    n = global_batch
    for ax, size in (("pod", pod), ("data", data)):
        if ax in mesh.shape and n % size == 0 and n >= size:
            batch_axes += (ax,)
            n //= size
    no_tp = variant == "no_tp"
    kv_heads_on_model = (cfg.n_kv_heads % tp == 0 and cfg.n_kv_heads >= tp
                         and not no_tp)
    ep_mode = cfg.n_experts > 0 and cfg.n_experts % tp == 0 and not no_tp
    seq_axes: tuple[str, ...] = ()
    if not kv_heads_on_model and kind in ("decode", "prefill"):
        seq_axes += ("model",)
    if not batch_axes and kind == "decode":
        seq_axes = ("data",) + seq_axes
    env = AxisEnv(
        dp=batch_axes,
        fsdp=(("data",) if (fsdp and kind == "train") else ())
        + (("model",) if (no_tp and kind == "train") else ()),
        tp=() if no_tp else ("model",),
        ep=("model",) if ep_mode else (),
        # sequence parallelism for train/prefill, not for recurrent-state
        # archs (their per-step loop slices the time dim every trip)
        sp=("model",) if kind in ("train", "prefill")
        and not cfg.has_recurrent_state else (),
        active=True,
        sizes=tuple((name, mesh.shape[name]) for name in mesh.shape),
    )
    return CellPlan(env=env, kv_heads_on_model=kv_heads_on_model,
                    ep_mode=ep_mode, batch_axes=batch_axes,
                    seq_axes_kv=seq_axes)


# ---------------------------------------------------------------------------
# abstract params / states
# ---------------------------------------------------------------------------

def abstract_params(cfg: ArchConfig, precision: str | None = None):
    """The model's tree on the meta device (quantized as ``init_params``
    would, with ``precision``)."""
    init = init_encdec_params if cfg.is_encoder_decoder else init_params
    return init(cfg, device=META, precision=precision)


def abstract_states(cfg: ArchConfig, batch: int, max_seq: int,
                    int8_kv: bool = False) -> list:
    return init_states(cfg, batch, max_seq, int8_kv=int8_kv, device=META)


def stacked_states(states: list, cfg: ArchConfig) -> list:
    """The reference's state layout of a per-layer state list: one entry a
    block-pattern position (None where it holds no state), each leaf a
    ``LeafShape`` stacked over the periods."""
    def stack(leaf):
        return LeafShape((cfg.n_periods,) + tuple(leaf.shape), leaf.dtype)
    return [map_with_path(states[pos], lambda _, leaf: stack(leaf))
            for pos in range(cfg.period)]


# ---------------------------------------------------------------------------
# state sharding specs (mirrors the reference's stacked state layout)
# ---------------------------------------------------------------------------

def _axes(axes: tuple[str, ...]):
    """A spec entry as ``PartitionSpec`` writes it: None, a name, or a
    tuple of two or more."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _state_leaf_spec(path: str, shape, plan: CellPlan) -> tuple:
    """Leaves are stacked over periods: dim0 = period."""
    b = _axes(plan.batch_axes)
    if path.endswith(("/xk", "/xv")):
        # static cross-attn KV (periods, B, Sv, H, D): shard the head_dim
        hd_ok = shape[-1] % 16 == 0
        return (None, b, None, None, "model" if hd_ok else None)
    if "/kv/" in path or path.endswith("pos_ids"):
        seq = _axes(plan.seq_axes_kv)
        if path.endswith(("/k", "/v", "/k_s", "/v_s")):
            head = "model" if plan.kv_heads_on_model else None
            dims = [None, b, seq, head] + [None] * (len(shape) - 4)
            return tuple(dims[: len(shape)])
        if path.endswith("pos_ids"):
            return (None, b, seq)
    # recurrent states: (periods, B, heads/d, ...) — dim 2 on model when
    # divisible (the model axis is 16 in both meshes), else replicated
    if len(shape) >= 3:
        tp_ok = shape[2] % 16 == 0
        return (None, b, "model" if tp_ok else None,
                *([None] * (len(shape) - 3)))
    if len(shape) == 2:
        return (None, b)
    return (None,)


def state_specs(states: list, plan: CellPlan, cfg: ArchConfig) -> list:
    """The spec of every leaf of ``stacked_states(states, cfg)``."""
    return map_with_path(stacked_states(states, cfg),
                         lambda path, leaf: _state_leaf_spec(
                             path, leaf.shape, plan))


# ---------------------------------------------------------------------------
# input specs per cell kind
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, kind: str, seq_len: int, global_batch: int,
                int8_kv: bool = False) -> dict:
    """Meta tensors standing in for every input of the cell's step."""
    b = global_batch
    i32 = torch.int32
    if kind == "train":
        specs = {"tokens": _meta((b, seq_len), i32),
                 "labels": _meta((b, seq_len), i32)}
        if cfg.family == "vlm":
            specs["kv_source"] = _meta((b, cfg.n_vision_tokens, cfg.d_model),
                                       torch.bfloat16)
        if cfg.is_encoder_decoder:
            specs["frames"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                    torch.float32)
        return specs
    if kind not in ("prefill", "decode"):
        raise ValueError(kind)
    t = seq_len if kind == "prefill" else 1
    specs = {"tokens": _meta((b, t), i32), "positions": _meta((b, t), i32),
             "states": abstract_states(cfg, b, seq_len, int8_kv)}
    if cfg.family == "vlm":
        specs["kv_source"] = _meta((b, cfg.n_vision_tokens, cfg.d_model),
                                   torch.bfloat16)
    if cfg.is_encoder_decoder:
        specs["kv_source"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                   torch.bfloat16)
    return specs
