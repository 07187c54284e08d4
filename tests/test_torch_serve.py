"""The port's serving engine against ``repro.serve.ServingEngine`` on the CPU
(starcoder2-3b-reduced at w8a8 and codeqwen1.5-7b-reduced at w4a8, both
with the int8 KV cache and the packed schedule; the other schedules,
sampling and warmup are ``test_torch_schedules.py``'s, self-speculation
``test_torch_speculative.py``'s).

Greedy tokens must match the reference's on fixed-seed prompts.  A
divergence is allowed only at a step where the reference's own top-2 logit
margin is below ``MARGIN_TOL`` (the forward tolerance of
``test_torch_models.py``): there the two argmaxes are a near-tie that the
tolerance cannot order.  After a divergence the contexts differ and the rest
of that request is not compared.
"""
import numpy as np
import jax
import pytest

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.dist import TPConfigError
from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
from repro_torch.serve import (AdmissionQueue, QueueFullError, ServeConfig,
                               ServingEngine, percentile)

MARGIN_TOL = 0.02
ARCH = "starcoder2-3b"
SCFG = dict(batch_lanes=3, max_seq=64, int8_kv=True, token_budget=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH, precision="w8a8", reduced=True)
    jp = jptq(jinit_params(jax.random.PRNGKey(3), jcfg))
    cfg = get_config(ARCH, precision="w8a8", reduced=True)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (3, 13, 6, 9)]
    return jcfg, jp, cfg, tp, prompts


def drain(engine, prompts, max_new=8):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new=max_new, request_id=i)
    return {r["id"]: r["tokens"] for r in engine.run_until_drained()}


def jax_margin(jcfg, jp, context):
    """The reference's top-2 margin of the next-token logits after
    ``context`` (one cached prefill: the packed engine's logits at that
    position are the same by the reference's own schedule contract)."""
    st = jinit_states(jcfg, 1, SCFG["max_seq"], int8_kv=True)
    n = len(context)
    lg, _ = jax.jit(lambda p, t, s: jforward(
        p, jcfg, t, positions=np.arange(n, dtype=np.int32)[None], states=s))(
        jp, np.asarray(context, np.int32)[None], st)
    top = np.sort(np.asarray(lg[0, -1]))[-2:]
    return float(top[1] - top[0])


@pytest.fixture(scope="module")
def setup_qwen_w4a8():
    """codeqwen1.5-7b-reduced: the reference's float weights, PTQ'd by each
    side with the default W4 policy (bit-identical trees)."""
    jcfg = jget_config("codeqwen1.5-7b", precision="w4a8", reduced=True)
    jf = jinit_params(jax.random.PRNGKey(5), jcfg)
    cfg = get_config("codeqwen1.5-7b", precision="w4a8", reduced=True)
    tp = ptq_quantize_params(from_reference(jax.device_get(jf), cfg,
                                            device="cpu"),
                             policy=DEFAULT_W4_POLICY)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 12, 2, 8)]
    return jcfg, jptq(jf, policy=J_W4_POLICY), cfg, tp, prompts


def _assert_greedy_match(jcfg, jp, cfg, tp, prompts):
    ref = drain(JServingEngine(jp, jcfg, JServeConfig(**SCFG)), prompts)
    mine = drain(ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu"),
                 prompts)
    assert sorted(mine) == sorted(ref)
    for rid, want in ref.items():
        got = mine[rid]
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                m = jax_margin(jcfg, jp, prompts[rid] + want[:i])
                assert m < MARGIN_TOL, (rid, i, a, b, m)
                break
        else:
            assert len(got) == len(want), (rid, got, want)


def test_greedy_tokens_match_reference(setup):
    _assert_greedy_match(*setup)


def test_greedy_tokens_match_reference_codeqwen_w4a8(setup_qwen_w4a8):
    _assert_greedy_match(*setup_qwen_w4a8)


def test_lane_isolation(setup):
    _, _, cfg, tp, prompts = setup
    eng = ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu")
    out = drain(eng, [prompts[1]] * 3)
    assert out[0] == out[1] == out[2]
    alone = drain(ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu"),
                  [prompts[2]])
    mixed = drain(ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu"),
                  [prompts[0], prompts[2], prompts[3], prompts[1]])
    assert alone[0] == mixed[1]


def test_stats_and_buckets(setup):
    _, _, cfg, tp, prompts = setup
    eng = ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu")
    assert eng.chunk_buckets == (1, 2, 4, 8)
    drain(eng, prompts, max_new=4)
    st = eng.stats
    assert st["requests"] == 4 and len(eng.finished) == 4
    assert st["prompt_tokens"] == sum(map(len, prompts))
    assert 1 in st["forwards"] and "mode=packed" in eng.stats_summary()
    with pytest.raises(ValueError):
        eng.submit([], max_new=2)


@pytest.mark.parametrize("kw", [dict(tp=2)])
def test_unported_features_raise(setup, kw):
    # tensor parallelism is ported: tp > 1 without a TP group is refused
    _, _, cfg, tp, _ = setup
    with pytest.raises(TPConfigError, match="TP group of 2 ranks"):
        ServingEngine(tp, cfg, ServeConfig(**{**SCFG, **kw}), device="cpu")


def test_queue_copy_behaves_like_reference():
    from repro.serve.queue import AdmissionQueue as JQ
    from repro.serve.queue import percentile as jpercentile
    reqs = [{"priority": p, "n": i} for i, p in enumerate([0, 2, 1, 2, 0])]
    a, b = AdmissionQueue(), JQ()
    for r in reqs:
        a.push(r)
        b.push(r)
    assert [a.pop()["n"] for _ in reqs] == [b.pop()["n"] for _ in reqs]
    bounded = AdmissionQueue(limit=1)
    bounded.push({})
    with pytest.raises(QueueFullError):
        bounded.push({})
    xs = [5.0, 1.0, 3.0, 9.0]
    for q in (0, 50, 99, 100):
        assert percentile(xs, q) == jpercentile(xs, q)

