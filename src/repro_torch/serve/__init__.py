"""Serving engine of the port: packed, chunked and tokenwise schedules,
greedy or sampled on the reference's threefry streams, self-speculation,
dense or paged KV caches, cross-attention features per lane."""
from .engine import (ServeConfig, ServingEngine, decode_step, packed_step,
                     prefill_step)
from .kv_pool import PagedKVPool, PoolExhaustedError
from .queue import AdmissionQueue, QueueFullError, percentile

__all__ = ["AdmissionQueue", "PagedKVPool", "PoolExhaustedError",
           "QueueFullError", "ServeConfig", "ServingEngine", "decode_step",
           "packed_step", "percentile", "prefill_step"]
