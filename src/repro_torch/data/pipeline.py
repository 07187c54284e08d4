"""Deterministic token pipeline: restart-exact, host-sharded, prefetched
(a copy of ``repro.data.pipeline``, which is pure numpy: the port imports
nothing of the JAX package, so it keeps its own).

Fault-tolerance contract: batch content is a pure function of
(seed, step, host_index) — after a checkpoint restore at step N, every host
regenerates exactly the batches it would have seen, with no data-loader
state to save.  Real deployments swap the synthesis for a deterministic
tokenized-shard reader keyed the same way; everything above this module is
unchanged.

The synthetic stream is a mixture of Zipf-distributed unigrams and repeated
n-gram motifs so that a language model has actual structure to learn.  The
batches stay numpy arrays on the host; ``train.Trainer`` moves each to the
parameters' device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _motif_bank(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    return rng.integers(2, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))


def batch_for_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """The restart-exact batch function (pure in (cfg, step))."""
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_index)
    b, t = cfg.host_batch, cfg.seq_len
    # Zipf unigrams clipped to vocab
    toks = rng.zipf(cfg.zipf_a, size=(b, t + 1)).astype(np.int64)
    toks = np.minimum(toks, cfg.vocab_size - 1)
    # overlay motifs (learnable n-gram structure)
    bank = _motif_bank(cfg)
    n_spans = max(t // (4 * cfg.motif_len), 1)
    for i in range(b):
        for _ in range(n_spans):
            m = bank[rng.integers(cfg.n_motifs)]
            start = rng.integers(0, t + 1 - cfg.motif_len)
            toks[i, start:start + cfg.motif_len] = m
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


class TokenPipeline:
    """Background-prefetching iterator over ``batch_for_step``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
