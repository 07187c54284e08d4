"""Architecture configuration: a copy of ``repro.models.config``.

The port keeps its own copy so that it imports nothing of the JAX package;
the dataclass and ``reduced()`` are unchanged.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # per-layer block pattern, cycled over n_layers.  Block kinds:
    #   "attn"        self-attention + dense MLP
    #   "attn_swa"    sliding-window self-attention + MLP/MoE
    #   "moe"         self-attention + MoE FFN
    #   "moe_swa"     sliding-window attention + MoE
    #   "xattn"       cross-attention (+ MLP) to encoder/vision features
    #   "mamba2"      Mamba-2 (SSD) block
    #   "mlstm"       xLSTM matrix-memory block
    #   "slstm"       xLSTM scalar-memory block (sequential)
    #   "shared_attn" attention+MLP block with PERIOD-SHARED params (zamba2)
    block_pattern: tuple[str, ...] = ("attn",)
    d_head: int = 0                # 0 -> d_model // n_heads
    # attention details
    rope_theta: float = 1e6
    sliding_window: int = 0        # 0 -> full attention
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0              # expert hidden dim (if != d_ff)
    capacity_factor: float = 1.25
    # SSM / xLSTM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0             # 0 -> derived (d_inner // 64)
    # encoder-decoder (whisper) / vlm
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # whisper encoder positions (stub frontend)
    n_vision_tokens: int = 1601    # llama-3.2-vision cross-attn keys (stub)
    activation: str = "silu"       # silu | gelu
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # execution
    precision: str = "bf16"        # bf16 | w8a8 | w4a8 (integer inference)
    remat: bool = True             # activation checkpointing on layer scan

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple so the LM head shards on any TP
        degree (odd vocabs — whisper's 51865 — would otherwise replicate
        the logits).  Padded columns are masked to -inf in forward()."""
        return -(-self.vocab_size // 128) * 128

    @property
    def block_kinds(self) -> tuple[str, ...]:
        """The n_layers-long unrolled pattern."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def has_recurrent_state(self) -> bool:
        """True if any block carries a per-timestep recurrence (Mamba/
        xLSTM): such blocks consume every fed token in order, so serving
        pad tokens would corrupt state and sequence-parallel sharding
        would collective-shuffle the time dim on every scan trip."""
        return bool({"mamba2", "mlstm", "slstm"} & set(self.block_kinds))

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory is O(1) or window-bounded (sub-quadratic)."""
        kinds = set(self.block_kinds)
        has_recurrent = kinds & {"mamba2", "mlstm", "slstm"}
        full_attn = {"attn", "moe", "xattn"} & kinds
        swa_only = kinds & {"attn_swa", "moe_swa"}
        if has_recurrent:
            # hybrid archs: fine if remaining attention is shared/windowed
            return not (full_attn - {"xattn"}) or "shared_attn" in kinds
        return bool(swa_only) and not full_attn

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder (whisper is enc-dec)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(period, 2 if period == 1 else period),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            moe_d_ff=64 if self.n_experts else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            n_experts_per_tok=min(self.n_experts_per_tok, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=2 if self.ssm_state else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            n_audio_frames=64,
            n_vision_tokens=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            remat=False,
        )
