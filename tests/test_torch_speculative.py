"""Self-speculation in the port on the CPU: speculative == vanilla, and both
equal to the reference engine's tokens.

The cases of ``tests/test_speculative.py``: the proposer (the port's copy of
``ngram_propose``, against the reference's on random contexts); k in
{2, 4, 8} x dense / paged, packed and chunked; adversarial drafts (all
accepted — the vanilla continuation itself —, all rejected, random garbage);
lanes preempted mid-request under pool pressure.  The model is
starcoder2-3b-reduced w8a8 with the int8 KV cache (the reference's weights,
PTQ'd by the reference and converted), so the integer forward is exact and
the port's tokens equal the reference's bit for bit; the bf16 model (the
port's own init) is held to vanilla within the port.
"""
import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models.attention import rollback_cache as jrollback
from repro.quant import ptq_quantize_params as jptq
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve.draft import ngram_propose as jngram

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.models import init_params
from repro_torch.models.attention import rollback_cache
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.draft import ngram_propose

# repetition-heavy prompts and one aperiodic: the proposer both fires and
# stays harmless where it has nothing to propose
PROMPTS = [([5, 6, 7, 8] * 6)[:20], ([11, 12, 13] * 7)[:18],
           ([3, 4] * 8)[:14], [9, 3, 11, 4, 2, 30, 31]]
BASE = dict(batch_lanes=2, max_seq=64, token_budget=8, int8_kv=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("starcoder2-3b", precision="w8a8", reduced=True)
    jp = jptq(jinit_params(jax.random.PRNGKey(0), jcfg))
    cfg = get_config("starcoder2-3b", precision="w8a8", reduced=True)
    return jcfg, jp, cfg, from_reference(jax.device_get(jp), cfg,
                                         device="cpu")


def engine(model, **kw):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, ServeConfig(**{**BASE, **kw}), device="cpu")


def drain(eng, prompts=PROMPTS, max_new=12):
    for i, p in enumerate(prompts):
        eng.submit(list(p), max_new=max_new, request_id=i)
    done = eng.run_until_drained()
    assert len(done) == len(prompts)
    return {d["id"]: d["tokens"] for d in done}


_VANILLA = {}


def vanilla(model, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _VANILLA:
        _VANILLA[key] = drain(engine(model, **kw))
    return _VANILLA[key]


@pytest.fixture(scope="module")
def reference(model):
    """The reference engine's vanilla drain (its speculative drains equal
    it: tests/test_speculative.py)."""
    jcfg, jp = model[:2]
    return drain(JServingEngine(jp, jcfg, JServeConfig(**BASE)))


# ---------------------------------------------------------------------------
# the proposer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctx,k,want", [
    ([1, 2, 9, 9, 1, 2, 7, 8, 1, 2], 3, [7, 8, 1]),
    ([1, 2, 3, 7, 5, 3, 9, 1, 2, 3], 2, [7, 5]),
    ([4, 5, 6] * 5, 6, [4, 5, 6, 4, 5, 6]),
    ([7, 3] + [9] * 10, 5, [9] * 5),
    ([1, 2, 3, 4, 5, 6, 7], 4, []),
    ([1, 2, 1, 9], 0, []), ([], 4, []), ([7], 4, []),
    ([1, 2, 3, 9, 1, 2, 3], 8, [9, 1, 2, 3])])
def test_proposer_cases(ctx, k, want):
    assert ngram_propose(ctx, k) == want == jngram(ctx, k)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31), st.integers(0, 8), st.integers(0, 40),
       st.integers(2, 5))
def test_proposer_equals_the_reference(seed, k, n, alphabet):
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(0, alphabet, size=n)]
    assert ngram_propose(ctx, k) == jngram(ctx, k)


def test_dense_rollback_equals_the_reference():
    rng = np.random.default_rng(1)
    pos = rng.integers(-1, 40, size=(3, 48)).astype(np.int32)
    keep = np.array([5, 1 << 30, 17], np.int32)
    want = np.asarray(jrollback({"pos_ids": pos}, keep)["pos_ids"])
    cache = {"pos_ids": torch.from_numpy(pos.copy())}
    assert rollback_cache(cache, torch.from_numpy(keep))["pos_ids"] is \
        cache["pos_ids"]                             # in place
    assert np.array_equal(cache["pos_ids"].numpy(), want)


# ---------------------------------------------------------------------------
# speculative == vanilla == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_packed_speculation_is_exact(model, reference, k, paged):
    eng = engine(model, spec_k=k, paged=paged)
    got = drain(eng)
    assert got == vanilla(model, paged=paged) == reference
    st_ = eng.stats
    assert st_["spec_drafted"] > 0 and st_["spec_accepted"] > 0
    assert eng._spec_k == min(k, BASE["token_budget"] - 1)
    assert f"spec[k={eng._spec_k} " in eng.stats_summary()
    if paged:
        eng.pool.check()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [2, 8])
def test_chunked_speculation_is_exact(model, reference, k, paged):
    eng = engine(model, spec_k=k, paged=paged, token_budget=0,
                 prefill_chunk=8)
    assert eng.mode == "chunked"
    assert drain(eng) == vanilla(model, paged=paged, token_budget=0,
                                 prefill_chunk=8) == reference
    assert eng.stats["spec_accepted"] > 0


def _oracle(want: dict):
    """All-accept drafts: the vanilla continuation of the request whose
    context this is."""
    def propose(ctx, k):
        for i, p in enumerate(PROMPTS):
            full = list(p) + want[i]
            if full[:len(ctx)] == ctx:
                return full[len(ctx):len(ctx) + k]
        return []
    return propose


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", ["oracle", "wrong", "random"])
def test_adversarial_drafts(model, reference, kind, paged):
    want = vanilla(model, paged=paged)
    eng = engine(model, spec_k=4, paged=paged)
    rng = random.Random(0)
    vocab = model[2].vocab_size
    eng._draft_fn = {
        "oracle": _oracle(want),
        "wrong": lambda ctx, k: [(ctx[-1] + 1 + j) % vocab for j in range(k)],
        "random": lambda ctx, k: [rng.randrange(vocab) for _ in range(k)],
    }[kind]
    assert drain(eng) == want == reference
    st_ = eng.stats
    assert st_["spec_drafted"] > 0
    if kind == "oracle":
        assert st_["spec_accepted"] == st_["spec_drafted"]
        assert st_["steps"] < engine_steps(model, paged)
    if paged:
        eng.pool.check()


def engine_steps(model, paged):
    eng = engine(model, paged=paged)
    drain(eng)
    return eng.stats["steps"]


@pytest.mark.parametrize("k", [2, 4])
def test_pressure_preempts_speculating_lanes_exactly(model, k):
    """A tiny pool under 4 speculating lanes: lanes are preempted and
    resumed (drafts halved meanwhile), and the drain equals the
    unconstrained vanilla run."""
    kw = dict(batch_lanes=4, paged=True, token_budget=16)
    base = vanilla(model, **kw)
    eng = engine(model, spec_k=k, pool_pages=8, page_size=8, **kw)
    assert drain(eng) == base
    m = eng.serving_metrics()
    assert m["preemptions"] >= 1 and m["spec_drafted"] > 0
    eng.pool.check()


def test_sampled_and_tokenwise_engines_never_speculate(model):
    """A sampled engine serves vanilla (its PRNG streams unchanged by
    spec_k), and tokenwise mode never speculates."""
    kw = dict(temperature=0.9, seed=3)
    eng = engine(model, spec_k=4, **kw)
    assert eng._spec_k == 0
    assert drain(eng) == vanilla(model, **kw)
    assert eng.stats["spec_drafted"] == 0
    eng = engine(model, spec_k=4, token_budget=0, prefill_chunk=0)
    assert eng.mode == "tokenwise" and eng._spec_k == 0
    assert drain(eng) == vanilla(model)


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_speculation_equals_vanilla(paged):
    """The bf16 forward (float GEMMs, bf16 cache) within the port: a span's
    rows are the sequential decode's, so speculation changes nothing."""
    cfg = get_config("starcoder2-3b", reduced=True)
    params = init_params(cfg, seed=0, device="cpu")
    kw = dict(batch_lanes=2, max_seq=64, token_budget=8, paged=paged)

    def run(**extra):
        eng = ServingEngine(params, cfg, ServeConfig(**kw, **extra),
                            device="cpu")
        return drain(eng), eng

    want, _ = run()
    got, eng = run(spec_k=4)
    assert got == want and eng.stats["spec_drafted"] > 0
