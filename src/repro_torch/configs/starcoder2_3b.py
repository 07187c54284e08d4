"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, plain GELU MLP,
LayerNorm, qkv bias.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=1e5,
    qkv_bias=True,
    activation="gelu",
    norm_type="layernorm",
)
