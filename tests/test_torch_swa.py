"""Sliding-window attention and MoE serving on the CPU, against the JAX
reference (``repro.models`` and ``repro.serve.ServingEngine``).

* The ring cache: mixtral-8x7b-reduced (window 32) fed token by token past
  the window, the port's ring of 32 slots against the reference's ring
  (logits within ``W8A8_TOL`` at w8a8, ``BF16_TOL`` at bf16 away from a
  router near-tie: ``test_torch_moe.near_ties``) and against the port's
  own cache that never wraps (window masking only: within the reference
  test's 0.25, ``tests/test_models.py:133``, at bf16, and equal at w8a8).
* The dense ``attn_swa`` configs of ``tests/test_system.py:215-260``
  (``swa-test``: a 70-token prompt over a 32-slot window; ``swa-wrap``: a
  96-token prompt whose 16-token spans cross the ring's seam) served packed
  == chunked == tokenwise by the port, each equal to the reference engine's
  same schedule.
* MoE serving (mixtral-8x7b-reduced w8a8 and qwen2-moe-a2.7b-reduced w4a8,
  int8 KV): capacity drops depend on every row of a step, so the reference
  itself does not give packed == chunked == tokenwise; each port schedule
  — packed, chunked, tokenwise, paged (mixtral: live pages capped at the
  window) and ``spec_k`` 4 on a wrapped ring — is held against the
  reference engine's same schedule.  A divergence is allowed only where the
  reference's top-2 margin after the common context is below
  ``MARGIN_TOL``.
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.models.config import ArchConfig as JArchConfig
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.models import forward, init_states
from repro_torch.models.config import ArchConfig
from repro_torch.serve import ServeConfig, ServingEngine

from test_torch_moe import compared, near_ties, table_path  # noqa: F401

MARGIN_TOL = 0.02
W8A8_TOL = 0.02
BF16_TOL = 0.02
KEY = jax.random.PRNGKey(0)


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["bf16", "w8a8"])
def test_ring_cache_matches_full_window(prec):
    jcfg = jget_config("mixtral-8x7b", precision=prec, reduced=True)
    cfg = get_config("mixtral-8x7b", precision=prec, reduced=True)
    assert cfg.sliding_window == 32
    jp = jinit_params(KEY, jcfg)
    if prec == "w8a8":
        jp = jptq(jp)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    b, t = 1, 48
    toks = np.asarray(jax.random.randint(KEY, (b, t), 0, cfg.vocab_size),
                      np.int32)
    ring = init_states(cfg, b, max_seq=64, device="cpu")
    assert ring[0]["kv"]["k"].shape[1] == 32
    big = init_states(cfg, b, max_seq=64, device="cpu", window_slack=64)
    assert big[0]["kv"]["k"].shape[1] == 64
    jring = jinit_states(jcfg, b, max_seq=64)
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st))
    rows = []
    for i in range(t):
        pos = np.full((b, 1), i, np.int32)
        lj, jring = f(jp, toks[:, i:i + 1], pos, jring)
        (lr, ring), ties = near_ties(lambda: forward(
            tp, cfg, T(toks[:, i:i + 1]).long(), T(pos), ring))
        lb, big = forward(tp, cfg, T(toks[:, i:i + 1]).long(), T(pos), big)
        rows.append((np.asarray(lj), lr.numpy(), lb.numpy(), ties))
    lj = np.concatenate([r[0] for r in rows], 1)
    lr = np.concatenate([r[1] for r in rows], 1)
    lb = np.concatenate([r[2] for r in rows], 1)
    ties = torch.cat([r[3] for r in rows])
    tol = BF16_TOL if prec == "bf16" else W8A8_TOL
    assert compared(lj, lr, prec, ties).max() <= tol
    if prec == "bf16":
        assert np.abs(lr - lb).max() < 0.25
    else:
        assert np.array_equal(lr, lb)


# ---------------------------------------------------------------------------
# the dense sliding-window configs of tests/test_system.py
# ---------------------------------------------------------------------------

SWA = dict(name="swa-test", family="dense", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, d_head=16,
           block_pattern=("attn_swa",), sliding_window=32)
SWA_CASES = {
    # name: (max_seq, prompt, max_new, {schedule: ServeConfig overrides})
    "swa-test": (128, list(range(2, 72)), 5, {
        "tokenwise": dict(token_budget=0, prefill_chunk=0),
        "chunked": dict(token_budget=0, prefill_chunk=4),
        "packed": dict(token_budget=8),
        "chunked64": dict(token_budget=0, prefill_chunk=64)}),
    "swa-wrap": (256, [2 + (i * 7) % 250 for i in range(96)], 4, {
        "tokenwise": dict(token_budget=0, prefill_chunk=0),
        "packed": dict(token_budget=16),
        "chunked": dict(token_budget=0, prefill_chunk=16)}),
}


@pytest.mark.parametrize("name", list(SWA_CASES))
def test_swa_schedules_equal_and_match_reference(name):
    max_seq, prompt, max_new, schedules = SWA_CASES[name]
    jcfg = JArchConfig(**dict(SWA, name=name))
    cfg = ArchConfig(**dict(SWA, name=name))
    jp = jinit_params(KEY, jcfg)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    got = {}
    for sched, kw in schedules.items():
        ref = JServingEngine(jp, jcfg, JServeConfig(batch_lanes=2,
                                                    max_seq=max_seq, **kw))
        ref.submit(prompt, max_new=max_new, request_id=0)
        want = ref.run_until_drained()[0]["tokens"]
        eng = ServingEngine(tp, cfg, ServeConfig(batch_lanes=2,
                                                 max_seq=max_seq, **kw),
                            device="cpu")
        eng.submit(prompt, max_new=max_new, request_id=0)
        got[sched] = eng.run_until_drained()[0]["tokens"]
        assert got[sched] == want, sched
        if eng.mode != "tokenwise":
            assert eng.states[0]["kv"]["k"].shape[1] == 32 + \
                eng.chunk_buckets[-1]
    assert all(v == got["tokenwise"] for v in got.values())


# ---------------------------------------------------------------------------
# MoE serving, schedule by schedule against the reference engine
# ---------------------------------------------------------------------------

MOE_BASE = dict(batch_lanes=3, max_seq=96, int8_kv=True)
MOE_SCHEDULES = {
    "packed": dict(token_budget=16),
    "chunked": dict(token_budget=0, prefill_chunk=8),
    "tokenwise": dict(token_budget=0, prefill_chunk=0),
    "paged": dict(token_budget=16, paged=True, page_size=8),
    "spec4": dict(token_budget=16, spec_k=4),
}


def _moe_model(arch, prec):
    jcfg = jget_config(arch, precision=prec, reduced=True)
    jf = jinit_params(jax.random.PRNGKey(2), jcfg)
    jp = jptq(jf, policy=J_W4_POLICY) if prec == "w4a8" else jptq(jf)
    cfg = get_config(arch, precision=prec, reduced=True)
    return jcfg, jp, cfg, from_reference(jax.device_get(jp), cfg,
                                         device="cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _moe_model("mixtral-8x7b", "w8a8")


@pytest.fixture(scope="module")
def qwen_moe():
    return _moe_model("qwen2-moe-a2.7b", "w4a8")


def _prompts(cfg):
    # a repetitive prompt (the n-gram drafter finds matches) and two
    # random ones; the longest wraps mixtral-reduced's 32 + 16-slot ring
    rng = np.random.default_rng(9)
    rep = [5, 6, 7, 8, 9, 10] * 9
    return [rep, rng.integers(2, cfg.vocab_size, 20).tolist(),
            rng.integers(2, cfg.vocab_size, 7).tolist()]


def _drain(eng, prompts, max_new=10):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i)
    return {d["id"]: d["tokens"] for d in eng.run_until_drained()}


def _margin(jcfg, jp, context):
    st = jinit_states(jcfg, 1, MOE_BASE["max_seq"], int8_kv=True,
                      window_slack=16)
    n = len(context)
    lg, _ = jax.jit(lambda p, t, s: jforward(
        p, jcfg, t, positions=np.arange(n, dtype=np.int32)[None], states=s))(
        jp, np.asarray(context, np.int32)[None], st)
    top = np.sort(np.asarray(lg[0, -1]))[-2:]
    return float(top[1] - top[0])


def _assert_match(model, sched):
    jcfg, jp, cfg, tp = model
    kw = {**MOE_BASE, **MOE_SCHEDULES[sched]}
    prompts = _prompts(cfg)
    want = _drain(JServingEngine(jp, jcfg, JServeConfig(**kw)), prompts)
    eng = ServingEngine(tp, cfg, ServeConfig(**kw), device="cpu")
    got = _drain(eng, prompts)
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                m = _margin(jcfg, jp, prompts[rid] + w[:i])
                assert m < MARGIN_TOL, (sched, rid, i, a, b, m)
                break
        else:
            assert len(g) == len(w), (sched, rid, g, w)
    return eng


@pytest.mark.parametrize("sched", list(MOE_SCHEDULES))
def test_mixtral_serving_matches_reference(mixtral, sched):
    eng = _assert_match(mixtral, sched)
    cfg = mixtral[2]
    if sched == "paged":
        assert eng.paged and eng._cap_window == cfg.sliding_window
    elif sched != "tokenwise":
        # the ring: window + the largest bucket, wrapped by the long prompt
        kv = eng.states[0]["kv"]
        assert kv["k"].shape[1] == cfg.sliding_window + eng.chunk_buckets[-1]
    if sched == "spec4":
        assert eng.stats["spec_drafted"] > 0


@pytest.mark.parametrize("sched", ["packed", "chunked", "tokenwise"])
def test_qwen2_moe_serving_matches_reference(qwen_moe, sched):
    _assert_match(qwen_moe, sched)
