"""Serving engine of the port: packed, chunked and tokenwise schedules,
greedy or sampled on the reference's threefry streams, self-speculation,
dense or paged KV caches."""
from .engine import ServeConfig, ServingEngine, packed_step
from .queue import AdmissionQueue, QueueFullError, percentile

__all__ = ["AdmissionQueue", "QueueFullError", "ServeConfig", "ServingEngine",
           "packed_step", "percentile"]
