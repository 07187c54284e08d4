"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (kv=16) moe_d_ff=1408 vocab=151936, MoE 60e top-4 with
a 4x-width shared expert (sigmoid-gated), qkv bias, tied embeddings.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,             # dense-equivalent ff (shared expert width)
    vocab_size=151936,
    block_pattern=("moe",),
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    rope_theta=1e6,
    qkv_bias=True,
    activation="silu",
    norm_type="rmsnorm",
    tie_embeddings=True,
)
