"""codeqwen1.5-7b [dense] — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (kv=32: full MHA) d_ff=13440 vocab=92416, SwiGLU,
RMSNorm, RoPE theta 1e6, qkv bias (Qwen1.5 lineage).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    block_pattern=("attn",),
    rope_theta=1e6,
    qkv_bias=True,
    activation="silu",
    norm_type="rmsnorm",
)
