"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0 means the blocks have
no separate FFN (the m/sLSTM up/down projections carry the capacity).
Pattern choice (documented; the paper sweeps ratios): one sLSTM per four
blocks, rest mLSTM — the 1:3 ratio used by the strongest 350M variant.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    norm_type="layernorm",
    activation="gelu",
    tie_embeddings=True,
)
