"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding-window attention (4096): the KV cache is a ring of window + slack
slots per lane.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("moe_swa",),
    sliding_window=4096,
    n_experts=8,
    n_experts_per_tok=2,
    rope_theta=1e6,
    activation="silu",
    norm_type="rmsnorm",
)
