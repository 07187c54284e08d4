"""Self-speculative draft proposal: prompt-lookup / n-gram drafting (the
port's copy of ``repro.serve.draft``, host code only).

The verifier (``serve/engine.py``) accepts a draft token iff it equals the
model's own greedy argmax at that position, so the draft source sets the
speed (acceptance rate), never the output: any pure function of the visible
context is a correct proposer, and the tests swap in adversarial ones.
"""
from __future__ import annotations

# n-gram window for the suffix lookup: the longest match first, down to
# MIN_NGRAM (a 0-gram "match" would draft from an arbitrary offset)
MAX_NGRAM = 3
MIN_NGRAM = 1


def ngram_propose(context: list[int], k: int,
                  max_ngram: int = MAX_NGRAM,
                  min_ngram: int = MIN_NGRAM) -> list[int]:
    """Draft up to ``k`` tokens continuing ``context`` by prompt lookup.

    Finds an earlier occurrence of the longest trailing n-gram
    (``min_ngram <= n <= max_ngram``) and returns the tokens that followed
    it.  Among same-length matches recency wins, but a match whose
    continuation is clipped by the context end loses to an older one with
    a full ``k``-token continuation (on a periodic tail the most recent
    match overlaps the end, one period back predicts the whole next
    period).  Returns fewer than ``k`` tokens when every match sits near
    the end, ``[]`` when nothing repeats.  Pure and deterministic."""
    if k <= 0:
        return []
    n_ctx = len(context)
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        pat = context[n_ctx - n:]
        best_i, best_len = -1, 0
        for i in range(n_ctx - n - 1, -1, -1):
            if context[i:i + n] == pat:
                cont = min(k, n_ctx - i - n)
                if cont >= k:                      # full draft, most recent
                    return list(context[i + n:i + n + k])
                if cont > best_len:
                    best_i, best_len = i, cont
        if best_len:
            return list(context[best_i + n:best_i + n + best_len])
    return []
