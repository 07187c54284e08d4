"""Serving engine: ONE packed token-budget forward + continuous batching.

Port of ``repro.serve.engine`` for packed mode with a dense KV cache and
greedy decoding.  Every iteration builds one ``(B, T_bucket)`` batch in
which each active lane contributes a contiguous span of tokens — generating
lanes 1 token, prefilling lanes their share of ``token_budget`` — right-
padded with position -1 tokens whose cache writes are dropped.  Each lane's
next token is the argmax of its logits at its own last VALID row.  Bucket 1
is the all-decode steady state; with an int8 cache on the card it runs the
int8-KV decode kernel.

Unlike the reference, which returns new states and commits them with a
lane mask, the port writes the caches in place: a lane outside the plan
feeds only pads (position -1), whose writes are dropped, so its cache is
left exactly as the lane-masked commit would leave it.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
paged caches, self-speculation (``spec_k``), tensor parallel (``tp``),
sampling (``temperature > 0``, the reference's threefry streams), the
chunked / tokenwise schedules (``token_budget=0``) and ``run_stream``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models import ArchConfig, forward, init_states
from ..models.lm import LM
from .queue import AdmissionQueue, QueueFullError, percentile


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The reference's ServeConfig fields that the port reads.  ``paged``,
    ``spec_k``, ``tp``, ``temperature`` and ``token_budget`` keep the
    reference's meaning; values whose feature is not ported raise."""

    batch_lanes: int = 8
    max_seq: int = 2048
    int8_kv: bool = False
    temperature: float = 0.0     # 0 = greedy (the only mode ported)
    eos_token: int = 1
    token_budget: int = 32       # packed-step tokens per iteration
    queue_limit: int = 0         # admission-queue bound; 0 = unbounded
    paged: bool = False
    spec_k: int = 0
    tp: int = 1


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §A8)")


def _check_supported(cfg: ArchConfig, scfg: ServeConfig) -> None:
    if scfg.paged:
        raise _not_ported("paged KV serving")
    if scfg.spec_k > 0:
        raise _not_ported("self-speculative decoding (spec_k > 0)")
    if scfg.tp > 1:
        raise _not_ported("tensor-parallel serving (tp > 1)")
    if scfg.temperature > 0.0:
        raise _not_ported("sampled decoding (temperature > 0)")
    if scfg.token_budget <= 0:
        raise _not_ported("the chunked / tokenwise schedules (token_budget=0)")
    if cfg.has_recurrent_state:
        raise _not_ported("tokenwise serving of recurrent archs")


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
            raise _not_ported("tokenwise serving (no bucket below max_seq)")
        self.states = init_states(cfg, b, serve_cfg.max_seq,
                                  int8_kv=serve_cfg.int8_kv, device=self.device)
        self.lane_pos = np.zeros(b, np.int32)
        self.lane_active = np.zeros(b, bool)
        self.lane_request: list[Any] = [None] * b
        self.queue = AdmissionQueue(serve_cfg.queue_limit)
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
            "ttft_ms": [], "tpot_ms": [],
            "slo_ttft_miss": 0, "slo_tpot_miss": 0,
        }

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

    def _admit(self) -> None:
        for lane in range(self.scfg.batch_lanes):
            if self.lane_active[lane]:
                continue
            if not self.queue:
                return
            req = self.queue.pop()
            self._reset_lane(lane)
            self.lane_pos[lane] = 0
            req["_pending_prompt"] = req["prompt"][:]
            self.lane_request[lane] = req
            self.lane_active[lane] = True

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
        dev = self.device
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
        """One iteration: admit → pack → forward → commit → complete."""
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
        while (self.queue or self.lane_active.any()) and it < max_iters:
            self.step()
            it += 1
        return self.finished

    def run_stream(self, schedule, max_iters: int = 1_000_000):
        raise _not_ported("run_stream (timed arrivals)")

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
        m = self.serving_metrics()
        if m["completed"]:
            out += (f" ttft_p50/p99={m['ttft_p50_ms']:.1f}/"
                    f"{m['ttft_p99_ms']:.1f}ms tpot_p50/p99="
                    f"{m['tpot_p50_ms']:.2f}/{m['tpot_p99_ms']:.2f}ms")
        return out
