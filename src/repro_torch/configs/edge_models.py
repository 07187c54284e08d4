"""The paper's own benchmark suite: 7 edge transformer models (Table II);
the port's copy of ``repro.configs.edge_models``.

Kernel-composition percentages as published (midpoints of the reported
ranges), from which ``chip_smoke.py`` phase 10 derives each model's
effective MOPS on the simulated fabric from the per-kernel metrics.
"""
from __future__ import annotations

# % kernel composition per model (Table II midpoints; rows sum to ~100 with
# the remainder attributed to data movement / glue, as in the paper)
EDGE_MODELS: dict[str, dict[str, float]] = {
    "tiny-vit":          {"conv": 27.5, "gemm": 50.0, "gelu": 5.0, "norm": 5.0, "quant": 0.0, "sftmx": 5.0},
    "mobile-bert":       {"conv": 0.0,  "gemm": 65.0, "gelu": 5.0, "norm": 6.5, "quant": 2.5, "sftmx": 5.0},
    "tiny-bert":         {"conv": 0.0,  "gemm": 65.0, "gelu": 5.0, "norm": 6.5, "quant": 2.5, "sftmx": 5.0},
    "fast-vit":          {"conv": 62.5, "gemm": 17.5, "gelu": 5.0, "norm": 5.5, "quant": 2.5, "sftmx": 4.0},
    "efficientformer-v2": {"conv": 57.5, "gemm": 22.5, "gelu": 6.5, "norm": 6.0, "quant": 2.5, "sftmx": 4.0},
    "whisper-tiny":      {"conv": 0.0,  "gemm": 67.5, "gelu": 5.0, "norm": 6.5, "quant": 2.5, "sftmx": 5.0},
    "distil-bert":       {"conv": 0.0,  "gemm": 67.5, "gelu": 5.0, "norm": 6.5, "quant": 2.5, "sftmx": 5.0},
}

# Table II input sizes (dtype tags as published)
KERNEL_INPUTS = {
    "conv":  "Img int8 [3,128,128]; Wgt int8 8x[3,3,3]; Bias int32 [8]",
    "gemm":  "A int8 [32,64]; B int8 [64,32]",
    "gelu":  "Input int8 [4,16]; Weight int8 [16]; Bias int32 [16]",
    "norm":  "Input int8 [64]; Gamma int8 [8]; Beta int8 [8]",
    "quant": "Input int16 [64]; Scale int32 [1]",
    "sftmx": "QK_BUF int8 [32]; ATTN_MASK int32 [32]; BIAS int32 [32,32]",
}
