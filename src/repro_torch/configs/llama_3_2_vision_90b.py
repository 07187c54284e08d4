"""llama-3.2-vision-90b [vlm] — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, SwiGLU, RMSNorm.
Every fifth layer cross-attends to precomputed vision tokens (the frontend
is a stub); its attention and MLP outputs are tanh-gated (zero-init).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=5e5,
    activation="silu",
    norm_type="rmsnorm",
    n_vision_tokens=1601,
)
