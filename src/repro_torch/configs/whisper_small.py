"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  12 encoder layers and 12
decoder layers (self + cross attention), plain GELU MLP, LayerNorm, tied
embeddings.  The conv frontend is a stub: the encoder reads precomputed
frame embeddings (B, 1500, d).  A learned pos-embed on the encoder; the
decoder uses RoPE, as in the reference.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=("dec",),
    is_encoder_decoder=True,
    n_encoder_layers=12,
    n_audio_frames=1500,
    rope_theta=1e4,
    activation="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
)
