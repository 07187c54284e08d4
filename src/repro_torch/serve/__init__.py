"""Serving engine of the port (packed mode, dense cache, greedy)."""
from .engine import ServeConfig, ServingEngine, packed_step
from .queue import AdmissionQueue, QueueFullError, percentile

__all__ = ["AdmissionQueue", "QueueFullError", "ServeConfig", "ServingEngine",
           "packed_step", "percentile"]
