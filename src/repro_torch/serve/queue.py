"""Admission control + serving-latency bookkeeping for the engine front end.

A copy of ``repro.serve.queue`` (stdlib only), kept so that the port imports
nothing of the JAX package.

The continuous-batching front end (serve/engine.py) turns an unbounded
async request stream into bounded engine work:

* ``AdmissionQueue`` — the waiting room between ``submit()`` and lane
  admission.  Strict priority order (higher ``priority`` first), FIFO
  within a priority level (submission order), so equal-priority traffic
  keeps the offline drain's request order and the PRNG-stream contract
  (tokens keyed by submission id) is unaffected by queueing.  ``limit``
  bounds the depth: a push past it raises ``QueueFullError`` — overload
  is an EXPLICIT rejection the caller sees at submission time, never a
  silent drop and never an allocator failure deep inside a step.
* ``percentile`` — nearest-rank percentiles for the TTFT (time to first
  token) and TPOT (time per output token) samples the engine records.
  Latency is measurement-only: scheduling decisions never read the
  clock, so a request's tokens stay a pure function of (seed,
  submission id, position) whatever the timing.
"""
from __future__ import annotations

import heapq


class QueueFullError(RuntimeError):
    """The bounded admission queue rejected a submission (backpressure).

    Raised by ``ServingEngine.submit`` when ``ServeConfig.queue_limit``
    requests are already waiting.  The request was NOT enqueued and holds
    no engine state; the caller sheds it, retries later, or routes it
    elsewhere — the engine itself never drops work silently."""


class AdmissionQueue:
    """Priority admission queue with an optional depth bound.

    Heap entries are ``(-priority, order, request)``: higher ``priority``
    first, submission order within a level.  ``order`` is a private
    monotone counter, so request dicts are never compared."""

    def __init__(self, limit: int = 0):
        self.limit = int(limit)
        self._heap: list[tuple[int, int, dict]] = []
        self._order = 0

    def push(self, req: dict) -> None:
        if self.limit and len(self._heap) >= self.limit:
            raise QueueFullError(
                f"admission queue full ({self.limit} waiting): request "
                f"rejected — retry later or raise ServeConfig.queue_limit")
        heapq.heappush(
            self._heap, (-int(req.get("priority", 0)), self._order, req))
        self._order += 1

    def pop(self) -> dict:
        """Highest-priority (then oldest) waiting request."""
        return heapq.heappop(self._heap)[2]

    def peek(self) -> dict:
        return self._heap[0][2]

    def clear(self) -> None:
        self._heap.clear()

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of ``xs`` (``q`` in [0, 100]); 0.0 when
    empty.  Nearest-rank (not interpolated) so a reported p99 is always a
    latency some request actually saw."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, -(-len(s) * q // 100) - 1))
    return float(s[int(k)])
