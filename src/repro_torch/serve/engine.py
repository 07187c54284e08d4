"""Serving engine: ONE packed token-budget forward + continuous batching.

Port of ``repro.serve.engine``.  Every iteration builds one ``(B, T_bucket)`` batch in which each
active lane contributes a contiguous span of tokens — generating lanes 1
token, prefilling lanes their share of ``token_budget`` — right-padded with
position -1 tokens whose cache writes are dropped.  Each lane's next token
comes from its logits at its own last VALID row.  Bucket 1 is the
all-decode steady state; with an int8 cache on the card every cache row runs
the int8-KV decode kernel (dense) or the paged decode kernel (paged), at
t = 1 or in their multi-row form, so a lane's tokens do not depend on how
its steps were batched.

Fallback schedules over the same forward:

* ``token_budget=0, prefill_chunk>1`` — chunked: prefill chunks and decode
  tokens run as two calls per iteration;
* both 0 — tokenwise: every lane feeds one token per call, prompts
  token-at-a-time.  Forced for recurrent-state archs (zamba2's Mamba-2
  blocks, xlstm's mLSTM and sLSTM blocks), whose recurrence would consume
  pad tokens, and when no bucket fits below ``max_seq``.

Greedy tokens are the same under the three schedules.  Sampling
(``temperature > 0``) uses PER-LANE streams of the reference's threefry
generator (``serve/prng.py``): ``fold_in(PRNGKey(seed), submission id)`` at
admission, folded again at each lane's last fed position, so a request's
tokens are a function of (seed, submission id, position) only — not of the
schedule, lane count or co-resident traffic.  ``warmup()`` requests live in
a reserved key space (``2^32 - 1 - bucket``) and do not advance the
submission counter.

SELF-SPECULATION (``spec_k``, ``serve/draft.py``): a greedy decode lane may
carry its last token plus up to k prompt-lookup draft tokens as one span;
the verifier reads the greedy argmax at every span row (causal masking
derives from positions, so row j sees none of the drafts after it), commits
the longest draft-matching run plus one corrective token, and withdraws the
rejected positions' KV writes (``kv_pool.truncate`` on paged,
``attention.rollback_cache`` on dense).  The output equals vanilla greedy
decode for ANY draft.  Sampled engines and tokenwise mode never speculate.

``paged=True`` replaces the dense per-lane caches with the PAGED KV pool:
one physical arena of fixed-size pages per attention layer, one page table
shared by every layer, and the refcounted allocator + radix prefix index of
``serve/kv_pool.py``.  A request whose prompt prefix is registered maps the
shared pages and skips prefill for that span; divergence inside a page
copies on write.  Under memory pressure the maybe-preempt stage swaps a
victim lane's pages to host memory and resumes it later into fresh pages, a
bit-exact round trip.  Paging is a memory-layout change only.  Recurrent
archs keep the dense layout.

Cross-attention archs (llama-3.2-vision-90b, whisper-small's decoder) take
``kv_source``, the (lanes, Sv, d) vision or encoder features of each lane:
the engine projects every cross layer's K/V once at init
(``precompute_cross_states``) and the steps read them; those states stay
dense (a ``paged=True`` request falls back silently, as in the reference).
``kv_source`` is fixed per lane, so a lane admitted anew keeps the cross K/V
that init wrote (the reference recomputes the same bits at every reset).

Sliding-window archs (mixtral-8x7b): each dense cache is a ring of window +
the largest bucket slots (``_window_slack``), so a span's writes never evict
keys inside the window of its earliest query; paged, every attention layer
being windowed, each lane's live pages are capped at the window
(``kv_pool.cap_window``).  MoE archs' capacity drops depend on every row of
a step, pads included, so a step's (B, T) rows are exactly the
reference's; a pad row's attention output depends on the cache layout (it
has no valid key), so for MoE archs paged and dense drains differ, as the
reference's do.

Unlike the reference, which returns new states, the port writes the KV
caches in place: a lane outside the plan feeds only pads (position -1),
whose writes are dropped, so its cache is left exactly as the lane-masked
commit would leave it.  Recurrent states (Mamba-2, mLSTM, sLSTM) come back
as new tensors and are committed under the lane mask (``_masked_commit``);
a lane admitted anew has every recurrent leaf reset to its init value.
The pool's clear, copy, swap-out and swap-in actions are in-place updates
of the arena too.  Every forward runs under ``torch.no_grad``, so a model
whose weights require grad (one that was trained) builds no graph here.

TENSOR PARALLEL (``tp`` > 1, ``dist/tp.py``): SPMD over ``torch.distributed``
— one process a rank, each running this engine on the same requests in the
same order with ``mesh=launch.mesh.make_tp_mesh(tp, backend, rank=r, ...)``
and its shard of the weights (``dist.shard_params`` or ``init_params(...,
shard=(r, tp))``).  The caches hold the rank's hkv / tp heads; the forward
runs unchanged inside ``tp_serving``, whose boundaries only gather and
exchange rows, so the logits — and every rank's tokens — are the tp = 1
ones.  The host bookkeeping (queue, plan, pool and page tables, drafts,
rollback) is replicated: it reads only tokens, which all ranks share, and
page copies, swap-outs and swap-ins act on each rank's own heads.
``run_stream``'s clock-driven arrivals are rank 0's (``dist.tp.agree``).
``tp_overlap`` picks the row-GEMM boundary ("auto": the reference's cost
rule, ``kernels.autotune.tp_serving_overlap``); ``tp_overlap_resolved``
holds the choice.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..dist.tp import TPConfigError, TPServing, agree, tp_serving
from ..dist.tp import validate_tp_serving
from ..kernels import autotune
from ..kernels.common import f32, resolve_device
from ..models import ArchConfig, forward, init_states, precompute_cross_states
from ..models.attention import gather_pages, rollback_cache, scatter_pages
from ..models.blocks import init_block_state
from ..models.layers import DEFAULT_DTYPE
from ..models.lm import LM
from . import prng
from .draft import ngram_propose
from .kv_pool import PagedKVPool, PoolExhaustedError
from .queue import AdmissionQueue, QueueFullError, percentile


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The reference's ServeConfig, with its defaults and meaning."""

    batch_lanes: int = 8
    max_seq: int = 2048
    int8_kv: bool = False
    temperature: float = 0.0     # 0 = greedy
    eos_token: int = 1
    token_budget: int = 32       # packed-step tokens per iteration; 0 = off
    prefill_chunk: int = 32      # chunked-mode cap (used when budget = 0)
    seed: int = 0                # base of the per-lane PRNG tree
    paged: bool = False          # paged KV pool + shared-prefix reuse
    page_size: int = 16          # KV page slots (demoted to divide max_seq)
    pool_pages: int = 0          # physical pages; 0 = auto-size
    queue_limit: int = 0         # admission-queue bound; 0 = unbounded
    swap: bool = True            # preempt + swap KV pages under pressure
    spec_k: int = 0              # self-speculative draft tokens per decode
    #                              step (0 = off; greedy engines only —
    #                              sampled engines silently serve vanilla)
    tp: int = 1                  # serving tensor parallel: ranks sharding
    #                              the step and the KV payloads; 1 = off
    tp_overlap: str = "auto"     # row-GEMM boundary: "barrier" (all-gather
    #                              then the full GEMM), "overlap" (all-to-all
    #                              token split, sequence-parallel stream) or
    #                              "auto" (the reference's cost rule)


@torch.no_grad()
def packed_step(params: LM, cfg: ArchConfig, tokens, positions, states,
                last_idx=None, kv_source=None):
    """The unified forward: (B, T) rows where each lane carries 1..T valid
    tokens (pads at position -1).  Returns each lane's logits at its last
    valid row (``last_idx`` (B,); default: the final row) + states."""
    logits, states = forward(params, cfg, tokens, positions=positions,
                             states=states, kv_source=kv_source)
    if last_idx is None:
        return logits[:, -1], states
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_idx], states


def prefill_step(params: LM, cfg: ArchConfig, tokens, positions, states,
                 kv_source=None):
    """Full-row prompt processing: ``packed_step`` with every row valid."""
    return packed_step(params, cfg, tokens, positions, states,
                       kv_source=kv_source)


def decode_step(params: LM, cfg: ArchConfig, token, position, states,
                kv_source=None):
    """One token for every lane: ``packed_step`` at bucket 1."""
    return packed_step(params, cfg, token, position, states,
                       kv_source=kv_source)


def _masked_commit(old_states: list, new_states: list, lane_mask) -> list:
    """Keep ``new_states`` only for the lanes in ``lane_mask`` (B,) bool.
    KV caches were written in place (pads dropped) and cross K/V are never
    written: both pass through; a recurrent state's leaves (B, ...) are
    selected per lane."""
    out = []
    for old, new in zip(old_states, new_states):
        if "kv" in new or "xk" in new:
            out.append(new)
            continue
        out.append({k: torch.where(
            lane_mask.view((-1,) + (1,) * (v.dim() - 1)), v, old[k])
            for k, v in new.items()})
    return out


def _sample(logits, temperature: float, keys):
    """Per-lane sampling: ``keys`` (B, 2), one PRNG stream per lane.  The
    reference runs this eagerly, so ``logits / temperature`` is a true
    division: by a 0-dim tensor on the logits' device (a Python float
    divisor on the card is a reciprocal product)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(keys, logits / f32(temperature, logits.device))


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServingEngine:
    """Slot-based continuous batching over the packed-step forward.

    ``params`` must live on ``device`` — the card unless the caller passes
    device='cpu'.  ``kv_source`` (lanes, Sv, d): the cross-attention
    features of each lane (module note).  ``mesh``: this rank's TP group
    (``launch.mesh.make_tp_mesh``), required at ``tp`` > 1, with ``params``
    the rank's shard."""

    def __init__(self, params: LM, cfg: ArchConfig, serve_cfg: ServeConfig,
                 device=None, kv_source=None, mesh=None):
        if serve_cfg.tp_overlap not in ("auto", "overlap", "barrier"):
            # validated even at tp=1, as the reference does
            raise ValueError(
                f"tp_overlap must be 'auto', 'overlap', or 'barrier', "
                f"got {serve_cfg.tp_overlap!r}")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        self.kv_source = kv_source
        b = serve_cfg.batch_lanes
        self._mode = self._resolve_mode()
        self._buckets = self._token_buckets()
        if self._mode != "tokenwise" and not self._buckets:
            # no bucket fits below max_seq (e.g. max_seq=2): serve
            # token-at-a-time instead of failing on an empty bucket table
            self._mode = "tokenwise"
        # sliding-window ring caches get max-bucket slack slots: a C-token
        # span write must not evict keys still inside the window of the
        # span's earliest query (a ring of W slots serves only C == 1)
        self._window_slack = self._buckets[-1] if self._buckets else 0
        # serving TP: the rank's group and boundary; its caches hold the
        # rank's hkv / tp heads
        self.tp_mesh = None
        self._tp: TPServing | None = None
        if serve_cfg.tp > 1:
            self._init_tp(params, mesh)
        scfg_kv = (cfg if self._tp is None else dataclasses.replace(
            cfg, n_kv_heads=cfg.n_kv_heads // serve_cfg.tp))
        self._paged = self._resolve_paged()
        self.pool: PagedKVPool | None = None
        if self._paged:
            # page size must divide max_seq so the gathered per-lane view is
            # slot-for-slot the dense cache layout: demote to the LARGEST
            # divisor <= requested
            ps = min(max(serve_cfg.page_size, 1), serve_cfg.max_seq)
            while serve_cfg.max_seq % ps:
                ps -= 1
            mp = serve_cfg.max_seq // ps
            # an explicit pool may be tiny (overload testing): clamp to one
            # lane's worst case + null + spare so a LONE resident lane always
            # completes — what makes preemption guaranteed progress
            n_pages = serve_cfg.pool_pages or (b + 2) * mp + 1
            n_pages = max(n_pages, mp + 2)
            self.pool = PagedKVPool(n_pages, ps, b, mp)
            # all attention layers windowed (mixtral-8x7b) -> the scheduler
            # caps each lane's LIVE pages at the window (full-attention
            # layers would still need the old keys, so mixed patterns keep
            # everything)
            kinds = set(cfg.block_pattern) & {
                "attn", "moe", "shared_attn", "attn_swa", "moe_swa"}
            self._cap_window = (cfg.sliding_window if kinds and
                                kinds <= {"attn_swa", "moe_swa"} else 0)
            self.states = init_states(scfg_kv, b, serve_cfg.max_seq,
                                      int8_kv=serve_cfg.int8_kv,
                                      device=self.device, paged_pages=n_pages,
                                      page_size=ps,
                                      window_slack=self._window_slack)
            # the page table every layer's arena shares (updated in place
            # before each forward)
            self._pt = self.states[0]["kv"]["pt"]
        else:
            self.states = init_states(scfg_kv, b, serve_cfg.max_seq,
                                      int8_kv=serve_cfg.int8_kv,
                                      device=self.device,
                                      window_slack=self._window_slack)
        if kv_source is not None:
            # static cross-attention KV: projected once, not per token
            with torch.no_grad():
                self.states = precompute_cross_states(params, cfg, kv_source,
                                                      self.states)
        # each recurrent layer's state at its init values for one lane (what
        # _reset_lane restores); None for a KV cache or cross K/V
        self._lane_init = [
            None if "kv" in st or "xk" in st else init_block_state(
                kind, cfg, 1, serve_cfg.max_seq, serve_cfg.int8_kv,
                DEFAULT_DTYPE, self.device)
            for kind, st in zip(cfg.block_kinds, self.states)]
        # self-speculation: greedy engines only (a sampled stream does not
        # follow the argmax the drafts are checked against), never
        # tokenwise (a recurrence cannot rewind); a speculating lane is a
        # (1 + k)-token span, so k stays one below the largest bucket
        self._spec_k = 0
        if (serve_cfg.spec_k > 0 and serve_cfg.temperature <= 0.0
                and self._mode != "tokenwise"):
            self._spec_k = min(serve_cfg.spec_k, self._buckets[-1] - 1)
        # pluggable proposer (tests swap in adversarial drafts — the output
        # holds for ANY proposer, only speed varies)
        self._draft_fn = ngram_propose
        self._no_rollback = 1 << 30   # per-lane sentinel: nothing to rewind
        # lane bookkeeping (host side); PRNG keys are (B, 2) 32-bit words
        self.lane_pos = np.zeros(b, np.int32)
        self.lane_active = np.zeros(b, bool)
        self.lane_request: list[Any] = [None] * b
        self.lane_keys = torch.zeros((b, 2), dtype=torch.int64)
        self.base_key = prng.prng_key(serve_cfg.seed)
        self.queue = AdmissionQueue(serve_cfg.queue_limit)
        self.preempted: list[dict] = []   # swapped-out, waiting to resume
        self.finished: list[dict] = []
        self._submitted = 0
        # read ONLY for latency measurement — no scheduling decision
        # depends on the clock
        self._clock = time.monotonic
        self.stats: dict[str, Any] = {}
        self.reset_stats()

    def _init_tp(self, params: LM, mesh) -> None:
        """Validate the arch, the group and the shard; resolve the
        row-GEMM boundary (the reference's rule over the largest step:
        lanes x the largest bucket) and hold the TP context every forward
        runs in."""
        tp = self.scfg.tp
        validate_tp_serving(self.cfg, tp, kv_source=self.kv_source)
        if mesh is None or mesh.size != tp:
            raise TPConfigError(
                f"tp={tp} serves across a TP group of {tp} ranks: each rank "
                f"passes mesh=launch.mesh.make_tp_mesh({tp}, backend, "
                f"rank=r, port=p) (got "
                f"{'no mesh' if mesh is None else f'a group of {mesh.size}'})")
        if params.tp_shard != (mesh.rank, tp):
            raise TPConfigError(
                f"rank {mesh.rank} of {tp} serves its own shard of the "
                f"weights (dist.shard_params(lm, {mesh.rank}, {tp}) or "
                f"init_params(..., shard=({mesh.rank}, {tp}))); these are "
                f"shard {params.tp_shard}")
        choice = self.scfg.tp_overlap
        if choice == "auto":
            rows = self.scfg.batch_lanes * (
                self._buckets[-1] if self._buckets else 1)
            choice = autotune.tp_serving_overlap(
                rows, self.cfg.d_model, self.cfg.d_ff,
                self.cfg.n_heads * self.cfg.head_dim, tp)
        self.tp_overlap_resolved = choice
        self.tp_mesh = mesh
        self._tp = TPServing(group=mesh.group, size=tp, rank=mesh.rank,
                             overlap=choice == "overlap")

    def _resolve_mode(self) -> str:
        """'packed' | 'chunked' | 'tokenwise' (recurrent archs: tokenwise —
        their recurrence would consume pad tokens)."""
        if self.cfg.has_recurrent_state:
            return "tokenwise"
        if self.scfg.token_budget > 0:
            return "packed"
        if self.scfg.prefill_chunk > 1:
            return "chunked"
        return "tokenwise"

    def _resolve_paged(self) -> bool:
        """Paged KV needs every per-forward state mutation to flow through
        the position-masked page scatter; recurrent-state and
        cross-attention archs keep the dense layout, as in the reference."""
        if (not self.scfg.paged or self.kv_source is not None
                or self.cfg.has_recurrent_state):
            return False
        return not any(k in ("xattn", "dec") for k in self.cfg.block_pattern)

    def _token_buckets(self) -> tuple[int, ...]:
        """Power-of-two row lengths up to the mode's cap (``token_budget``
        packed, ``prefill_chunk`` chunked), strictly below ``max_seq`` (a
        span of cache length would take the full-assign write).  Bucket 1
        is always present in packed mode; empty = tokenwise."""
        if self._mode == "tokenwise":
            return ()
        cap = (self.scfg.token_budget if self._mode == "packed"
               else self.scfg.prefill_chunk)
        out, b = [1] if self._mode == "packed" else [], 2
        while b <= cap:
            if b < self.scfg.max_seq:
                out.append(b)
            b *= 2
        if cap not in out and cap < self.scfg.max_seq:
            out.append(cap)
        return tuple(sorted(out))

    @property
    def mode(self) -> str:
        """Active schedule: 'packed', 'chunked', or 'tokenwise'."""
        return self._mode

    @property
    def chunk_buckets(self) -> tuple[int, ...]:
        """Static packed-row lengths in use (empty = tokenwise)."""
        return self._buckets

    @property
    def paged(self) -> bool:
        """True when the paged KV pool backs this engine's caches."""
        return self._paged

    def warmup(self) -> None:
        """Run every bucket outside any measured window: the kernels are
        built, cuBLAS and the caching allocator set up.  One LONE request of
        exactly each bucket's length (drained alone), one of bucket 1, then
        an all-pad batch per bucket (every position -1: no cache write
        lands, and no lane's recurrent state is committed).  Warmup requests
        use the RESERVED key space and do not advance the submission
        counter, so later requests' tokens are unchanged.  Clears the
        finished list and stats, and flushes the radix index when paged."""
        for bl in [b for b in self._buckets if b > 1]:
            self._submit_warmup([2 + (i % 5) for i in range(bl)], bl)
            self.run_until_drained()
        self._submit_warmup([2], 1)
        self.run_until_drained()
        b = self.scfg.batch_lanes
        for t in sorted({1, *self._buckets}):
            self._forward(np.zeros((b, t), np.int32),
                          np.full((b, t), -1, np.int32), np.zeros(b, np.int64),
                          np.zeros(b, bool), False, min(self._spec_k + 1, t))
        if self._paged:
            # warmup prompts must not linger as shareable prefixes
            self._apply_pool_actions(self.pool.flush_tree())
        self.finished.clear()
        self.reset_stats()

    def _submit_warmup(self, prompt: list[int], bucket: int) -> None:
        """Queue a warmup request keyed at the TOP of the uint32 fold range
        (real submission ids count up from 0 and never reach it); never
        touches ``_submitted``."""
        self.queue.push({"prompt": list(prompt), "max_new": 2,
                         "id": f"_warmup{bucket}", "generated": [],
                         "_seq": 2 ** 32 - 1 - bucket, "priority": 0,
                         "t_submit": self._clock()})

    def reset_stats(self) -> None:
        self.stats = {
            "requests": 0, "steps": 0, "forwards": {},
            "prompt_tokens": 0, "decode_tokens": 0, "pad_tokens": 0,
            "budget_tokens": 0, "prefix_len_hist": {},
            "queue_peak": 0, "rejected": 0,
            "preemptions": 0, "resumes": 0, "preempted_requests": [],
            "swap_out_pages": 0, "swap_in_pages": 0,
            "ttft_ms": [], "tpot_ms": [],
            "slo_ttft_miss": 0, "slo_tpot_miss": 0,
            # self-speculation; spec_throttled counts proposals halved
            # under pool pressure
            "spec_drafted": 0, "spec_accepted": 0, "spec_steps": 0,
            "spec_throttled": 0,
        }
        if self._paged:
            # prefix-hit / COW / eviction counters live in pool.stats, reset
            # in lockstep with the engine's
            self.pool.reset_stats()

    def _reset_lane(self, lane: int) -> None:
        """Clear one lane's states back to their init values (in place): a
        KV cache's positions, payload and scales; every leaf of a recurrent
        layer's state (Mamba-2's conv and SSD, mLSTM's C, n and m = -1e30,
        sLSTM's h, c, n = 1 and m) to ``init_block_state``'s one-lane
        value.  A cross layer's ``xk``/``xv`` keep what init wrote: the
        lane's ``kv_source`` does not change, so the reference's
        re-projection at every reset gives the same bits."""
        for st, init in zip(self.states, self._lane_init):
            if init is not None:
                for k, v in init.items():
                    st[k][lane] = v[0]
                continue
            if "kv" not in st:
                continue
            kv = st["kv"]
            kv["pos_ids"][lane] = -1
            kv["k"][lane] = 0
            kv["v"][lane] = 0
            if "k_s" in kv:
                kv["k_s"][lane] = 1.0
                kv["v_s"][lane] = 1.0

    # -- API -------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 32, request_id=None,
               *, priority: int = 0, ttft_slo_ms: float | None = None,
               tpot_slo_ms: float | None = None, on_token=None):
        """Queue one request (validated here, as in the reference).
        ``on_token(request_id, token)`` streams tokens as they commit."""
        n = len(prompt)
        if n == 0:
            raise ValueError("empty prompt: nothing to prefill (submit at "
                             "least one token)")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if n >= self.scfg.max_seq - max_new:
            raise ValueError(
                f"prompt of {n} tokens cannot fit max_new={max_new} within "
                f"max_seq={self.scfg.max_seq}: need "
                f"len(prompt) < max_seq - max_new")
        req = {"prompt": list(prompt), "max_new": max_new,
               "id": request_id, "generated": [],
               "_seq": self._submitted, "priority": int(priority),
               "ttft_slo_ms": ttft_slo_ms, "tpot_slo_ms": tpot_slo_ms,
               "on_token": on_token, "t_submit": self._clock()}
        try:
            self.queue.push(req)
        except QueueFullError:
            self.stats["rejected"] += 1
            raise
        self._submitted += 1
        self.stats["requests"] += 1
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self.queue))
        h = self.stats["prefix_len_hist"]
        bucket = _pow2_bucket(max(n, 1))
        h[bucket] = h.get(bucket, 0) + 1

    # -- the paged arena's device side -------------------------------------
    def _arenas(self) -> list[dict]:
        return [st["kv"] for st in self.states if "kv" in st]

    def _apply_pool_actions(self, actions) -> None:
        """Replay the allocator's device actions on the arena IN ORDER (an
        evicted page can be re-allocated as a COW target inside one batch),
        coalescing each run of clears into one ``ppos`` reset per layer."""
        pending: list[int] = []

        def flush():
            if pending:
                idx = torch.tensor(pending, dtype=torch.long,
                                   device=self.device)
                for kv in self._arenas():
                    kv["ppos"].index_fill_(0, idx, -1)
                pending.clear()

        for act in actions:
            if act[0] == "clear":
                pending.append(act[1])
                continue
            flush()
            _, src, dst, keep = act
            self._copy_page(src, dst, keep)
        flush()

    def _copy_page(self, src: int, dst: int, keep: int) -> None:
        """Copy-on-write: page ``src`` into ``dst`` in every layer, keeping
        the first ``keep`` slots' positions valid and clearing the rest (the
        source may carry its owner's tokens beyond the shared span)."""
        ps = self.pool.ps
        head = torch.arange(ps, device=self.device) < keep
        for kv in self._arenas():
            for key in ("pk", "pv", "pks", "pvs"):
                if key in kv:
                    kv[key][dst] = kv[key][src]
            kv["ppos"][dst] = torch.where(head, kv["ppos"][src],
                                          torch.full_like(kv["ppos"][src], -1))

    def _gather_pages_host(self, pids: list[int]) -> list[dict]:
        """Swap-out, device side: copy the pages' payloads (K/V, scales,
        positions) into HOST memory — one payload dict per layer.  Must run
        BEFORE the release actions clear the pages."""
        return [{k: v.cpu() for k, v in gather_pages(kv, pids).items()}
                for kv in self._arenas()]

    def _scatter_pages_device(self, pids: list[int],
                              payloads: list[dict]) -> None:
        """Swap-in, device side: write the saved payloads into the freshly
        allocated pages, layer by layer."""
        for kv, payload in zip(self._arenas(), payloads):
            scatter_pages(kv, pids, payload)

    # -- admission, preemption and swap ------------------------------------
    def _admit(self) -> None:
        """Fill free lanes: preempted requests resume FIRST (highest
        priority, then oldest), then the priority queue.  A resume blocked
        on pool capacity HOLDS its lane; in paged mode a new request is
        admitted only while the pool has headroom (free or evictable
        pages) — under pressure the queue is the backpressure."""
        for lane in range(self.scfg.batch_lanes):
            if self.lane_active[lane]:
                continue
            if self.preempted:
                req = min(self.preempted,
                          key=lambda r: (-r["priority"], r["_seq"]))
                if not self._try_resume(lane, req):
                    return
                continue
            if not self.queue:
                return
            if (self._paged and
                    self.pool.free_pages + self.pool.evictable_pages < 2):
                return
            req = self.queue.pop()
            if self._paged:
                # the previous request's pages were freed (and cleared) at
                # finish; the radix index maps any registered shared prefix
                # into the lane, so prefill SKIPS the shared span
                shared, actions = self.pool.admit(lane, req["prompt"])
                self._apply_pool_actions(actions)
                self.lane_pos[lane] = shared
                req["_pending_prompt"] = req["prompt"][shared:]
            else:
                self._reset_lane(lane)
                self.lane_pos[lane] = 0
                req["_pending_prompt"] = req["prompt"][:]
            self.lane_request[lane] = req
            self.lane_active[lane] = True
            # per-lane PRNG stream, keyed by SUBMISSION id: a request's
            # samples never depend on lane count or co-resident traffic
            self.lane_keys[lane] = prng.fold_in(self.base_key, req["_seq"])

    def _preempt_lane(self, lane: int) -> None:
        """Victim selected: swap the lane's KV pages to host memory and free
        the lane.  The request keeps its position, pending prompt and
        generated tokens, and its PRNG stream is keyed by submission id, so
        its resume produces the tokens of an uninterrupted run."""
        req = self.lane_request[lane]
        mapped, actions = self.pool.swap_out(lane)
        js = [j for j, _ in mapped]
        payloads = (self._gather_pages_host([p for _, p in mapped]) if js
                    else [])
        self._apply_pool_actions(actions)
        req["_swap"] = (js, payloads)
        req["_lane_pos"] = int(self.lane_pos[lane])
        self.lane_active[lane] = False
        self.lane_request[lane] = None
        self.preempted.append(req)
        st = self.stats
        st["preemptions"] += 1
        st["swap_out_pages"] += len(js)
        st["preempted_requests"].append(req["id"])

    def _try_resume(self, lane: int, req: dict) -> bool:
        """Swap a preempted request back in: rebind its logical pages to
        fresh physical pages, scatter the saved payload, restore the lane's
        counters and PRNG stream.  False (and no state change) when the
        pool cannot host it yet."""
        js, payloads = req["_swap"]
        try:
            pids, actions = self.pool.swap_in(lane, js)
        except PoolExhaustedError as e:
            self._apply_pool_actions(e.actions)
            return False
        self._apply_pool_actions(actions)
        if js:
            self._scatter_pages_device(pids, payloads)
        del req["_swap"]
        self.preempted.remove(req)
        self.lane_pos[lane] = req.pop("_lane_pos")
        self.lane_request[lane] = req
        self.lane_active[lane] = True
        self.lane_keys[lane] = prng.fold_in(self.base_key, req["_seq"])
        self.stats["resumes"] += 1
        self.stats["swap_in_pages"] += len(js)
        return True

    def _reserve_pages(self, plan: dict[int, int]) -> bool:
        """The maybe-preempt stage: back every planned span with lane-owned
        physical pages.  When the pool cannot, preempt a victim — lowest
        priority, then shortest progress, then lane index — drop it from
        the plan and retry.  A lone lane always fits (pool >= mp + 2), so
        this terminates.  Mutates ``plan``; False when nothing is left to
        run.  With one lane left, or ``swap`` off, ``PoolExhaustedError``
        surfaces."""
        while True:
            try:
                for lane in sorted(plan):
                    p0 = int(self.lane_pos[lane])
                    self._apply_pool_actions(
                        self.pool.ensure_writable(lane, p0, plan[lane]))
                    if self._cap_window:
                        self._apply_pool_actions(
                            self.pool.cap_window(lane, p0, self._cap_window))
                return bool(plan)
            except PoolExhaustedError as e:
                self._apply_pool_actions(e.actions)
                victims = [l for l in range(self.scfg.batch_lanes)
                           if self.lane_active[l]]
                if len(victims) <= 1 or not self.scfg.swap:
                    raise
                victim = min(victims, key=lambda l: (
                    self.lane_request[l]["priority"],
                    int(self.lane_pos[l]), l))
                self._preempt_lane(victim)
                plan.pop(victim, None)

    def _emit(self, req: dict, tok: int) -> None:
        """Commit one generated token: record first-token latency, stream
        it to the request's callback if any."""
        req["generated"].append(tok)
        if "t_first" not in req:
            req["t_first"] = self._clock()
        cb = req.get("on_token")
        if cb is not None:
            cb(req["id"], tok)

    def _finish_lane(self, lane: int) -> None:
        req = self.lane_request[lane]
        rec = {"id": req["id"], "prompt": req["prompt"],
               "tokens": req["generated"]}
        if "_spec_drafted" in req:
            rec["spec_drafted"] = req["_spec_drafted"]
            rec["spec_accepted"] = req["_spec_accepted"]
        if "t_first" in req:
            st = self.stats
            ttft = (req["t_first"] - req["t_submit"]) * 1e3
            st["ttft_ms"].append(ttft)
            rec["ttft_ms"] = ttft
            if (req.get("ttft_slo_ms") is not None
                    and ttft > req["ttft_slo_ms"]):
                st["slo_ttft_miss"] += 1
            n = len(req["generated"])
            if n > 1:
                tpot = (self._clock() - req["t_first"]) * 1e3 / (n - 1)
                st["tpot_ms"].append(tpot)
                rec["tpot_ms"] = tpot
                if (req.get("tpot_slo_ms") is not None
                        and tpot > req["tpot_slo_ms"]):
                    st["slo_tpot_miss"] += 1
        self.finished.append(rec)
        self.lane_active[lane] = False
        self.lane_request[lane] = None
        if self._paged:
            # drop the lane's page references; pages the prefix index still
            # names survive for future sharers, the rest clear and free
            self._apply_pool_actions(self.pool.lane_release(lane))

    def _check_done(self, lane: int) -> None:
        req = self.lane_request[lane]
        done = (len(req["generated"]) >= req["max_new"]
                or (req["generated"]
                    and req["generated"][-1] == self.scfg.eos_token)
                or self.lane_pos[lane] >= self.scfg.max_seq - 1)
        if done:
            self._finish_lane(lane)

    def _keys_at(self, key_pos) -> torch.Tensor:
        """(B, 2) sampling keys on the card: each lane's stream folded at
        its own fed position — per (request, position), never per engine
        iteration or schedule."""
        keys = prng.fold_in(self.lane_keys, torch.from_numpy(
            np.asarray(key_pos, np.int64)))
        return keys.to(self.device)

    # -- packed forward over a per-lane token plan ------------------------
    def _propose(self, lane: int) -> list[int]:
        """Draft tokens for a generating lane, stored on the request (read
        by ``_run_lanes``).  Capped at the remaining ``max_new`` budget and
        the lane's sequence room.  SWAP-AWARE THROTTLE: while any request
        sits preempted, drafts are halved (rejected rows are pure pad under
        pressure, and shorter spans shrink each step's page reservation);
        draft content never changes the output, so this changes speed
        only."""
        req = self.lane_request[lane]
        k = self._spec_k
        if k and self.preempted:
            k //= 2
            self.stats["spec_throttled"] += 1
        if k:
            k = min(k, req["max_new"] - len(req["generated"]) - 1,
                    self.scfg.max_seq - 1 - int(self.lane_pos[lane]))
        if k <= 0:
            req["_draft"] = []
        else:
            ctx = req["prompt"] + req["generated"]
            req["_draft"] = [int(t) for t in self._draft_fn(ctx, k)][:k]
        return req["_draft"]

    def _plan_tokens(self, lanes: list[int], budget: int) -> dict[int, int]:
        """Generating lanes take 1 token (plus their draft, when one
        exists); prefilling lanes waterfill the remaining budget, shortest
        pending prompt first (each at least 1, capped at the largest
        bucket, its pending prompt and its room).  Lanes whose prompt
        exhausted the sequence budget are finished here."""
        cap = self._buckets[-1] if self._buckets else 1
        prefilling = [l for l in lanes
                      if self.lane_request[l]["_pending_prompt"]]
        plan = {l: 1 + len(self._propose(l))
                for l in lanes if l not in prefilling}
        if not prefilling:
            return plan
        left = budget - sum(plan.values())
        order = sorted(prefilling, key=lambda l: (
            len(self.lane_request[l]["_pending_prompt"]), l))
        for i, lane in enumerate(order):
            room = self.scfg.max_seq - 1 - int(self.lane_pos[lane])
            if room <= 0:
                self._finish_lane(lane)
                continue
            share = max(left // (len(order) - i), 1)
            pending = len(self.lane_request[lane]["_pending_prompt"])
            plan[lane] = max(min(pending, share, cap, room), 1)
            left -= plan[lane]
        return plan

    @torch.no_grad()
    def _forward(self, tok, pos, last_idx, mask, commit_all: bool,
                 verify_rows: int) -> torch.Tensor:
        """One forward over (B, T) host arrays; commits the new states (all
        lanes, or those in ``mask``) and returns each lane's logits at its
        last ``verify_rows`` valid rows (B, R, V), clipped at row 0."""
        dev = self.device
        with tp_serving(self._tp):
            logits, new_states = forward(
                self.params, self.cfg,
                torch.from_numpy(tok).to(dev, torch.long),
                torch.from_numpy(pos).to(dev), self.states,
                kv_source=self.kv_source)
        self.states = (new_states if commit_all else _masked_commit(
            self.states, new_states, torch.from_numpy(mask).to(dev)))
        last = torch.from_numpy(last_idx).to(dev)
        idx = (last[:, None] - torch.arange(verify_rows - 1, -1, -1,
                                            device=dev)).clamp(min=0)
        rows = torch.arange(logits.shape[0], device=dev)[:, None]
        return logits[rows, idx]

    def _run_lanes(self, plan: dict[int, int]) -> None:
        """ONE packed forward: each lane in ``plan`` contributes its token
        count (prompt tokens while it consumes its prompt, else its last
        sampled token plus any draft), rows right-padded with position -1
        up to the smallest bucket that fits.  Logits gather at per-lane last
        valid indices; sampling keys fold at per-lane last fed positions.

        Speculating lanes (span 1 + m) run draft-then-verify: the span's
        greedy rows ARE sequential decode's outputs, so the verifier accepts
        drafts while they match the argmax of the PREVIOUS row, commits that
        run plus one corrective token under vanilla's stop rules, and
        withdraws the KV writes of every rejected position."""
        if not plan:
            return
        b = self.scfg.batch_lanes
        if self._paged:
            # back every logical page this step writes with a lane-owned
            # page (alloc / copy-on-write), preempting victims under
            # pressure, then upload the page table every layer shares
            if not self._reserve_pages(plan):
                return
            self._pt.copy_(torch.from_numpy(self.pool.table))
        need = max(plan.values())
        t = need if need == 1 else next(
            bk for bk in self._buckets if bk >= need)
        vr = min(self._spec_k + 1, t)         # verify rows
        tok = np.zeros((b, t), np.int32)
        pos = np.full((b, t), -1, np.int32)   # -1 = pad: cache write dropped
        last_idx = np.zeros(b, np.int64)
        mask = np.zeros(b, bool)
        key_pos = self.lane_pos.copy()
        n_prompt = 0
        speculating = False
        for lane, c in plan.items():
            req = self.lane_request[lane]
            p0 = int(self.lane_pos[lane])
            if req["_pending_prompt"]:
                tok[lane, :c] = req["_pending_prompt"][:c]
                n_prompt += c
            else:
                if req["generated"]:
                    tok[lane, 0] = req["generated"][-1]
                if c > 1:                     # speculative draft rows
                    tok[lane, 1:c] = req["_draft"][:c - 1]
                    speculating = True
            pos[lane, :c] = np.arange(p0, p0 + c)
            last_idx[lane] = c - 1
            key_pos[lane] = p0 + c - 1        # last fed position
            mask[lane] = True
        # paged mode always commits the whole tree: the arena has no lane
        # dimension to mask (pad writes are position-dropped)
        lg = self._forward(tok, pos, last_idx, mask,
                           self._paged or bool(mask.all()), vr)
        if speculating:                      # greedy engines only
            greedy = torch.argmax(lg, dim=-1).cpu().numpy()
            nxt = greedy[:, -1]
        else:
            keys = (self._keys_at(key_pos) if self.scfg.temperature > 0.0
                    else None)
            nxt = _sample(lg[:, -1], self.scfg.temperature, keys
                          ).cpu().numpy()
        st = self.stats
        st["forwards"][t] = st["forwards"].get(t, 0) + 1
        n_decode = 0
        rollback_keep = None                  # dense rewind bounds (B,)
        for lane, c in plan.items():
            req = self.lane_request[lane]
            p0 = int(self.lane_pos[lane])
            if req["_pending_prompt"]:
                self.lane_pos[lane] += c
                del req["_pending_prompt"][:c]
                if not req["_pending_prompt"]:
                    # boundary token: sampled from the last prompt logit,
                    # key folded at the last prompt position (= decode rule)
                    self._emit(req, int(nxt[lane]))
                    if self._paged:
                        # prompt fully in cache: register its pages in the
                        # radix index so later submissions can share them
                        self.pool.register_prompt(lane, req["prompt"])
                self._check_done(lane)
                continue
            draft = req.pop("_draft", [])
            if c == 1:                        # vanilla decode row
                self.lane_pos[lane] += 1
                n_decode += 1
                self._emit(req, int(nxt[lane]))
                self._check_done(lane)
                continue
            # draft-then-verify: v[j] = the greedy token after feeding span
            # row j (position p0 + j), the span's last c verify rows
            m = c - 1
            v = greedy[lane, vr - c:]
            a = 0
            while a < m and draft[a] == v[a]:
                a += 1
            st["spec_drafted"] += m
            st["spec_accepted"] += a
            st["spec_steps"] += 1
            req["_spec_drafted"] = req.get("_spec_drafted", 0) + m
            req["_spec_accepted"] = req.get("_spec_accepted", 0) + a
            # commit one token at a time under vanilla's stop rules
            e = 0
            for i in range(a + 1):
                e += 1
                self._emit(req, int(v[i]))
                if (len(req["generated"]) >= req["max_new"]
                        or int(v[i]) == self.scfg.eos_token
                        or p0 + e >= self.scfg.max_seq - 1):
                    break
            self.lane_pos[lane] = p0 + e
            n_decode += e
            if e < c:
                # rejected tail [p0+e, p0+c): withdraw its KV writes so the
                # cache is exactly what sequential decode would hold
                if self._paged:
                    self._apply_pool_actions(
                        self.pool.truncate(lane, p0 + e, p0 + c))
                else:
                    if rollback_keep is None:
                        rollback_keep = np.full(b, self._no_rollback,
                                                np.int64)
                    rollback_keep[lane] = p0 + e
            self._check_done(lane)
        if rollback_keep is not None:
            keep = torch.from_numpy(rollback_keep)
            for kv in self._arenas():
                rollback_cache(kv, keep)
        st["prompt_tokens"] += n_prompt
        st["decode_tokens"] += n_decode
        # rejected speculative rows count as pads: they bought no output
        st["pad_tokens"] += t * len(plan) - n_prompt - n_decode

    # -- scheduler --------------------------------------------------------
    def step(self) -> None:
        """One iteration: admit (resumes first) → maybe-preempt (inside
        ``_reserve_pages``) → pack → forward → commit → complete.  Packed:
        ONE forward mixing prefill chunk tokens and decode tokens under
        ``token_budget``.  Chunked: a prefill call, then a decode call over
        the lanes that were not prefilling.  Tokenwise: single-token rows
        for every lane."""
        self._admit()
        if not self.lane_active.any():
            return
        self.stats["steps"] += 1
        lanes = [l for l in range(self.scfg.batch_lanes)
                 if self.lane_active[l]]
        if self._mode == "packed":
            self.stats["budget_tokens"] += self.scfg.token_budget
            self._run_lanes(self._plan_tokens(lanes, self.scfg.token_budget))
            return
        if self._mode == "chunked":
            prefilling = [l for l in lanes
                          if self.lane_request[l]["_pending_prompt"]]
            if prefilling:
                # budget = lanes x cap: every lane gets a full chunk share
                self._run_lanes(self._plan_tokens(
                    prefilling, len(prefilling) * self._buckets[-1]))
            decoding = [l for l in lanes if self.lane_active[l]
                        and l not in prefilling]
            if decoding:
                # decode call: 1 token per lane + any speculative draft
                self._run_lanes({l: 1 + len(self._propose(l))
                                 for l in decoding})
            return
        # tokenwise: prompts feed one token per call (recurrent-arch safe)
        self._run_lanes({l: 1 for l in lanes})

    def run_until_drained(self, max_iters: int = 10_000) -> list[dict]:
        it = 0
        while (self.queue or self.preempted
               or self.lane_active.any()) and it < max_iters:
            self.step()
            it += 1
        return self.finished

    def run_stream(self, schedule, max_iters: int = 1_000_000):
        """Continuous serving against a TIMED arrival schedule
        ``[(offset_s, submit_kwargs), ...]``: each request is submitted, in
        schedule order, once the wall clock passes its offset, with engine
        iterations in between.  Submission ORDER alone keys the PRNG
        streams, so a streamed drain equals an offline drain of the same
        schedule.  Bounded-queue rejections are collected (as request ids),
        not raised.  Returns ``(finished, rejected_ids)``."""
        pending = collections.deque(schedule)
        t0 = self._clock()
        rejected = []
        it = 0
        while (pending or self.queue or self.preempted
               or self.lane_active.any()) and it < max_iters:
            # arrivals by rank 0's clock under TP: every rank submits the
            # same requests at the same iteration
            due = 0
            while (due < len(pending)
                   and self._clock() - t0 >= pending[due][0]):
                due += 1
            for _ in range(agree(due, self._tp, self.device)):
                _, kw = pending.popleft()
                try:
                    self.submit(**kw)
                except QueueFullError:
                    rejected.append(kw.get("request_id"))
            if (pending and not self.queue and not self.preempted
                    and not self.lane_active.any()):
                # idle gap before the next arrival: don't spin flat out
                time.sleep(min(max(
                    pending[0][0] - (self._clock() - t0), 0.0), 0.001))
            self.step()
            it += 1
        return self.finished, rejected

    def serving_metrics(self) -> dict:
        st = self.stats
        return {
            "completed": len(st["ttft_ms"]),
            "ttft_p50_ms": round(percentile(st["ttft_ms"], 50), 3),
            "ttft_p99_ms": round(percentile(st["ttft_ms"], 99), 3),
            "tpot_p50_ms": round(percentile(st["tpot_ms"], 50), 3),
            "tpot_p99_ms": round(percentile(st["tpot_ms"], 99), 3),
            "queue_peak": st["queue_peak"],
            "rejected": st["rejected"],
            "preemptions": st["preemptions"],
            "resumes": st["resumes"],
            "swap_out_pages": st["swap_out_pages"],
            "swap_in_pages": st["swap_in_pages"],
            "slo_ttft_miss": st["slo_ttft_miss"],
            "slo_tpot_miss": st["slo_tpot_miss"],
            "spec_drafted": st["spec_drafted"],
            "spec_accepted": st["spec_accepted"],
            "spec_throttled": st["spec_throttled"],
            "spec_accept_rate": round(
                st["spec_accepted"] / st["spec_drafted"], 4)
            if st["spec_drafted"] else 0.0,
        }

    def stats_summary(self) -> str:
        st = self.stats
        fwd = ",".join(f"{k}:{v}" for k, v in sorted(st["forwards"].items()))
        hist = ",".join(f"<={k}:{v}" for k, v in
                        sorted(st["prefix_len_hist"].items()))
        valid = st["prompt_tokens"] + st["decode_tokens"]
        total = valid + st["pad_tokens"]
        eff = 100.0 * valid / total if total else 100.0
        fill = (100.0 * valid / st["budget_tokens"]
                if st["budget_tokens"] else 0.0)
        share = 100.0 * st["decode_tokens"] / valid if valid else 0.0
        out = (f"mode={self._mode} requests={st['requests']} "
               f"steps={st['steps']} prompt_tokens={st['prompt_tokens']} "
               f"decode_tokens={st['decode_tokens']} (share={share:.0f}%) "
               f"row_eff={eff:.0f}% forwards[{fwd}] prefix_hist[{hist}]")
        if st["budget_tokens"]:
            out += f" budget_fill={fill:.0f}%"
        if self._spec_k:
            rate = (100.0 * st["spec_accepted"] / st["spec_drafted"]
                    if st["spec_drafted"] else 0.0)
            out += (f" spec[k={self._spec_k} drafted={st['spec_drafted']}"
                    f" accepted={st['spec_accepted']} rate={rate:.0f}%]")
        if self._paged:
            ps = self.pool.stats
            out += (f" paged[page={self.pool.ps} hits={ps['prefix_hits']}"
                    f" hit_tokens={ps['prefix_hit_tokens']}"
                    f" cow={ps['cow_copies']} evict={ps['evictions']}"
                    f" pages_peak={ps['pages_peak']}"
                    f" tree_pages={self.pool.tree_pages}]")
        m = self.serving_metrics()
        if m["completed"]:
            out += (f" ttft_p50/p99={m['ttft_p50_ms']:.1f}/"
                    f"{m['ttft_p99_ms']:.1f}ms tpot_p50/p99="
                    f"{m['tpot_p50_ms']:.2f}/{m['tpot_p99_ms']:.2f}ms")
        if m["preemptions"] or m["rejected"]:
            out += (f" overload[preempt={m['preemptions']}"
                    f" resume={m['resumes']} swap_pages="
                    f"{m['swap_out_pages']}/{m['swap_in_pages']}"
                    f" rejected={m['rejected']}"
                    f" queue_peak={m['queue_peak']}]")
        return out
