"""Config registry: --arch <id> -> ArchConfig.

Mirrors ``repro.configs.get_config``.  The port serves the dense decoders
starcoder2-3b, codeqwen1.5-7b, internlm2-20b (GQA, 6 query heads a KV head)
and yi-34b (GQA, 7 a KV head), the recurrent archs zamba2-2.7b (Mamba-2 and
shared attention) and xlstm-350m (mLSTM and sLSTM blocks), both tokenwise,
the mixture-of-experts decoders mixtral-8x7b (sliding-window attention
over a ring cache) and qwen2-moe-a2.7b (a sigmoid-gated shared expert), the
encoder-decoder whisper-small and llama-3.2-vision-90b (cross-attention to
stub vision tokens every fifth layer): the reference's ten archs.  Every
forward also runs without a cache.
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ArchConfig

ARCH_IDS = ["starcoder2-3b", "codeqwen1.5-7b", "zamba2-2.7b", "mixtral-8x7b",
            "qwen2-moe-a2.7b", "internlm2-20b", "yi-34b", "xlstm-350m",
            "whisper-small", "llama-3.2-vision-90b"]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, precision: str = "bf16",
               reduced: bool = False) -> ArchConfig:
    if arch_id.endswith("-reduced"):
        arch_id, reduced = arch_id[: -len("-reduced")], True
    if arch_id not in ARCH_IDS:
        raise NotImplementedError(
            f"unknown arch {arch_id!r} (ported: {ARCH_IDS})")
    mod = importlib.import_module(f".{_module_name(arch_id)}", __package__)
    cfg: ArchConfig = mod.CONFIG
    if reduced:
        cfg = cfg.reduced()
    if precision != cfg.precision:
        cfg = dataclasses.replace(cfg, precision=precision)
    return cfg


# ---------------------------------------------------------------------------
# Input shapes of the dry-run cells (``launch/dryrun.py``), the reference's
# (seq_len x global batch); decode_* and long_* are one token against a
# seq_len cache.
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cells(arch_id: str) -> list[str]:
    """Shape cells that apply to an arch (long_500k needs sub-quadratic)."""
    cfg = get_config(arch_id)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
