"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, SwiGLU, RMSNorm.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=("attn",),
    rope_theta=5e6,
    activation="silu",
    norm_type="rmsnorm",
)
