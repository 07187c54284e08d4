"""internlm2-20b [dense] — GQA [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, SwiGLU, RMSNorm.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=("attn",),
    rope_theta=1e6,
    activation="silu",
    norm_type="rmsnorm",
)
