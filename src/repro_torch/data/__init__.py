"""Deterministic synthetic data pipeline (host-sharded, restart-exact)."""
from .pipeline import DataConfig, TokenPipeline, batch_for_step  # noqa: F401

__all__ = ["DataConfig", "TokenPipeline", "batch_for_step"]
