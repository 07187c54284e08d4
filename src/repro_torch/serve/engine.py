"""Serving engine: ONE packed token-budget forward + continuous batching.

Port of ``repro.serve.engine`` for packed mode with a dense KV cache or the
paged KV pool, and greedy decoding.  Every iteration builds one ``(B, T_bucket)`` batch in
which each active lane contributes a contiguous span of tokens — generating
lanes 1 token, prefilling lanes their share of ``token_budget`` — right-
padded with position -1 tokens whose cache writes are dropped.  Each lane's
next token is the argmax of its logits at its own last VALID row.  Bucket 1
is the all-decode steady state; with an int8 cache on the card it runs the
int8-KV decode kernel (dense) or the paged decode kernel (paged).

``paged=True`` replaces the dense per-lane caches with the PAGED KV pool:
one physical arena of fixed-size pages per attention layer, one page table
shared by every layer, and the refcounted allocator + radix prefix index of
``serve/kv_pool.py``.  A request whose prompt prefix is registered maps the
shared pages and skips prefill for that span; divergence inside a page
copies on write.  Under memory pressure the maybe-preempt stage swaps a
victim lane's pages to host memory and resumes it later into fresh pages, a
bit-exact round trip.  Paging is a memory-layout change only: the tokens
equal the dense engine's.

Unlike the reference, which returns new states and commits them with a
lane mask, the port writes the caches in place: a lane outside the plan
feeds only pads (position -1), whose writes are dropped, so its cache is
left exactly as the lane-masked commit would leave it.  The pool's clear,
copy, swap-out and swap-in actions are in-place updates of the arena too.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
self-speculation (``spec_k``), tensor parallel (``tp``), sampling
(``temperature > 0``, the reference's threefry streams), the chunked /
tokenwise schedules (``token_budget=0``) and ``run_stream``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models import ArchConfig, forward, init_states
from ..models.attention import gather_pages, scatter_pages
from ..models.lm import LM
from .kv_pool import PagedKVPool, PoolExhaustedError
from .queue import AdmissionQueue, QueueFullError, percentile


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The reference's ServeConfig fields that the port reads, with its
    defaults and meaning; values whose feature is not ported raise."""

    batch_lanes: int = 8
    max_seq: int = 2048
    int8_kv: bool = False
    temperature: float = 0.0     # 0 = greedy (the only mode ported)
    eos_token: int = 1
    token_budget: int = 32       # packed-step tokens per iteration
    queue_limit: int = 0         # admission-queue bound; 0 = unbounded
    paged: bool = False          # paged KV pool + shared-prefix reuse
    page_size: int = 16          # KV page slots (demoted to divide max_seq)
    pool_pages: int = 0          # physical pages; 0 = auto-size
    spec_k: int = 0
    tp: int = 1


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"{item})")


def _check_supported(cfg: ArchConfig, scfg: ServeConfig) -> None:
    if scfg.spec_k > 0:
        raise _not_ported("self-speculative decoding (spec_k > 0)", "§A2")
    if scfg.tp > 1:
        raise _not_ported("tensor-parallel serving (tp > 1)", "§A10")
    if scfg.temperature > 0.0:
        raise _not_ported("sampled decoding (temperature > 0)", "§A1")
    if scfg.token_budget <= 0:
        raise _not_ported("the chunked / tokenwise schedules (token_budget=0)",
                          "§A1")
    if cfg.has_recurrent_state:
        raise _not_ported(f"serving {cfg.name} (recurrent state: the "
                          f"tokenwise schedule)", "§A1")


def packed_step(params: LM, cfg: ArchConfig, tokens, positions, states,
                last_idx=None):
    """The unified forward: (B, T) rows where each lane carries 1..T valid
    tokens (pads at position -1).  Returns each lane's logits at its last
    valid row (``last_idx`` (B,); default: the final row) + states."""
    logits, states = forward(params, cfg, tokens, positions=positions,
                             states=states)
    if last_idx is None:
        return logits[:, -1], states
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_idx], states


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServingEngine:
    """Slot-based continuous batching over the packed-step program family.

    ``params`` must live on ``device`` — the card unless the caller passes
    device='cpu'."""

    def __init__(self, params: LM, cfg: ArchConfig, serve_cfg: ServeConfig,
                 device=None):
        _check_supported(cfg, serve_cfg)
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg
        b = serve_cfg.batch_lanes
        self._buckets = self._token_buckets()
        if not self._buckets:
            raise _not_ported("tokenwise serving (no bucket below max_seq)",
                              "§A1")
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
            # all attention layers windowed -> the scheduler caps each lane's
            # LIVE pages at the window (no ported arch has such a pattern)
            kinds = set(cfg.block_pattern) & {
                "attn", "moe", "shared_attn", "attn_swa", "moe_swa"}
            self._cap_window = (cfg.sliding_window if kinds and
                                kinds <= {"attn_swa", "moe_swa"} else 0)
            self.states = init_states(cfg, b, serve_cfg.max_seq,
                                      int8_kv=serve_cfg.int8_kv,
                                      device=self.device, paged_pages=n_pages,
                                      page_size=ps)
            # the page table every layer's arena shares (updated in place
            # before each forward)
            self._pt = self.states[0]["kv"]["pt"]
        else:
            self.states = init_states(cfg, b, serve_cfg.max_seq,
                                      int8_kv=serve_cfg.int8_kv,
                                      device=self.device)
        self.lane_pos = np.zeros(b, np.int32)
        self.lane_active = np.zeros(b, bool)
        self.lane_request: list[Any] = [None] * b
        self.queue = AdmissionQueue(serve_cfg.queue_limit)
        self.preempted: list[dict] = []   # swapped-out, waiting to resume
        self.finished: list[dict] = []
        self._submitted = 0
        # read ONLY for latency measurement — no scheduling decision
        # depends on the clock
        self._clock = time.monotonic
        self.stats: dict[str, Any] = {}
        self.reset_stats()

    @property
    def mode(self) -> str:
        return "packed"

    @property
    def chunk_buckets(self) -> tuple[int, ...]:
        return self._buckets

    @property
    def paged(self) -> bool:
        """True when the paged KV pool backs this engine's caches."""
        return self._paged

    def _resolve_paged(self) -> bool:
        """Paged KV needs every per-forward state mutation to flow through
        the position-masked page scatter; recurrent-state and
        cross-attention archs keep the dense layout, as in the reference
        (the port serves neither yet)."""
        if not self.scfg.paged or self.cfg.has_recurrent_state:
            return False
        return not any(k in ("xattn", "dec") for k in self.cfg.block_pattern)

    def _token_buckets(self) -> tuple[int, ...]:
        """Power-of-two row lengths up to ``token_budget``, strictly below
        ``max_seq`` (a span of cache length would take the full-assign
        write); bucket 1 is always present."""
        cap = self.scfg.token_budget
        out, b = [1], 2
        while b <= cap:
            if b < self.scfg.max_seq:
                out.append(b)
            b *= 2
        if cap not in out and cap < self.scfg.max_seq:
            out.append(cap)
        return tuple(sorted(out))

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
        }
        if self._paged:
            # prefix-hit / COW / eviction counters live in pool.stats, reset
            # in lockstep with the engine's
            self.pool.reset_stats()

    def _reset_lane(self, lane: int) -> None:
        """Clear one lane's caches back to their init values (in place)."""
        for st in self.states:
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
        """Queue one request (validated here, as in the reference)."""
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
        return [st["kv"] for st in self.states]

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

    def _preempt_lane(self, lane: int) -> None:
        """Victim selected: swap the lane's KV pages to host memory and free
        the lane.  The request keeps its position, pending prompt and
        generated tokens, so its resume produces the tokens of an
        uninterrupted run."""
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
        fresh physical pages, scatter the saved payload, restore the lane.
        False (and no state change) when the pool cannot host it yet."""
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
        self.stats["resumes"] += 1
        self.stats["swap_in_pages"] += len(js)
        return True

    def _reserve_pages(self, plan: dict[int, int]) -> bool:
        """The maybe-preempt stage: back every planned span with lane-owned
        physical pages.  When the pool cannot, preempt a victim — lowest
        priority, then shortest progress, then lane index — drop it from
        the plan and retry.  A lone lane always fits (pool >= mp + 2), so
        this terminates.  Mutates ``plan``; False when nothing is left to
        run.  With one lane left, ``PoolExhaustedError`` surfaces."""
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
                if len(victims) <= 1:
                    raise
                victim = min(victims, key=lambda l: (
                    self.lane_request[l]["priority"],
                    int(self.lane_pos[l]), l))
                self._preempt_lane(victim)
                plan.pop(victim, None)

    def _emit(self, req: dict, tok: int) -> None:
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

    def _plan_tokens(self, lanes: list[int], budget: int) -> dict[int, int]:
        """Generating lanes take 1 token; prefilling lanes waterfill the
        remaining budget, shortest pending prompt first (each at least 1,
        capped at the largest bucket, its pending prompt and its room)."""
        cap = self._buckets[-1]
        prefilling = [l for l in lanes
                      if self.lane_request[l]["_pending_prompt"]]
        plan = {l: 1 for l in lanes if l not in prefilling}
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

    def _run_lanes(self, plan: dict[int, int]) -> None:
        """ONE packed forward over the plan; rows right-padded with
        position -1 up to the smallest bucket that fits."""
        if not plan:
            return
        b = self.scfg.batch_lanes
        dev = self.device
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
        tok = np.zeros((b, t), np.int32)
        pos = np.full((b, t), -1, np.int32)
        last_idx = np.zeros(b, np.int64)
        n_prompt = 0
        for lane, c in plan.items():
            req = self.lane_request[lane]
            p0 = int(self.lane_pos[lane])
            if req["_pending_prompt"]:
                tok[lane, :c] = req["_pending_prompt"][:c]
                n_prompt += c
            elif req["generated"]:
                tok[lane, 0] = req["generated"][-1]
            pos[lane, :c] = np.arange(p0, p0 + c)
            last_idx[lane] = c - 1
        lg, _ = packed_step(self.params, self.cfg,
                            torch.from_numpy(tok).to(dev, torch.long),
                            torch.from_numpy(pos).to(dev),
                            self.states, torch.from_numpy(last_idx).to(dev))
        nxt = torch.argmax(lg, dim=-1).cpu().numpy()
        st = self.stats
        st["forwards"][t] = st["forwards"].get(t, 0) + 1
        n_decode = 0
        for lane, c in plan.items():
            req = self.lane_request[lane]
            if req["_pending_prompt"]:
                self.lane_pos[lane] += c
                del req["_pending_prompt"][:c]
                if not req["_pending_prompt"]:
                    # boundary token: argmax of the last prompt logit
                    self._emit(req, int(nxt[lane]))
                    if self._paged:
                        # prompt fully in cache: register its pages in the
                        # radix index so later submissions can share them
                        self.pool.register_prompt(lane, req["prompt"])
                self._check_done(lane)
                continue
            self.lane_pos[lane] += 1
            n_decode += 1
            self._emit(req, int(nxt[lane]))
            self._check_done(lane)
        st["prompt_tokens"] += n_prompt
        st["decode_tokens"] += n_decode
        st["pad_tokens"] += t * len(plan) - n_prompt - n_decode

    # -- scheduler --------------------------------------------------------
    def step(self) -> None:
        """One iteration: admit (resumes first) → maybe-preempt (inside
        ``_reserve_pages``) → pack → forward → commit → complete."""
        self._admit()
        if not self.lane_active.any():
            return
        self.stats["steps"] += 1
        lanes = [l for l in range(self.scfg.batch_lanes)
                 if self.lane_active[l]]
        self.stats["budget_tokens"] += self.scfg.token_budget
        self._run_lanes(self._plan_tokens(lanes, self.scfg.token_budget))

    def run_until_drained(self, max_iters: int = 10_000) -> list[dict]:
        it = 0
        while (self.queue or self.preempted
               or self.lane_active.any()) and it < max_iters:
            self.step()
            it += 1
        return self.finished

    def run_stream(self, schedule, max_iters: int = 1_000_000):
        raise _not_ported("run_stream (timed arrivals)", "§A1")

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
        out = (f"mode=packed requests={st['requests']} "
               f"steps={st['steps']} prompt_tokens={st['prompt_tokens']} "
               f"decode_tokens={st['decode_tokens']} (share={share:.0f}%) "
               f"row_eff={eff:.0f}% forwards[{fwd}] prefix_hist[{hist}]"
               f" budget_fill={fill:.0f}%")
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
