"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Pattern: five Mamba-2 blocks then ONE shared attention+MLP block whose
parameters are reused across all nine periods (the Zamba trick: a single
transformer block amortized over the SSM backbone).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=1e4,
    activation="gelu",
    norm_type="rmsnorm",
    tie_embeddings=True,
)
