"""The port's serving schedules, sampling, warmup and ``run_stream`` on the
CPU, against ``repro.serve.ServingEngine`` and within the port
(starcoder2-3b-reduced w8a8 with the int8 KV cache: the reference's weights
PTQ'd by the reference and converted, as in ``test_torch_serve.py``).

The port-relevant cases of ``tests/test_system.py``'s ``TestServing`` and
``TestContinuousBatching``: packed == chunked == tokenwise, greedy and
sampled; max_new exact; max_seq truncation; a prompt of ``max_seq - 2``; a
prompt on a bucket boundary; a tiny max_seq degrading to tokenwise; warmup
not shifting streams; ``run_stream`` == an offline drain; ``on_token`` in
commit order.  Each schedule's tokens also equal the reference engine's on
the same prompts, greedy and sampled; a divergence is allowed only where
the reference's top-2 margin (of the logits, or of the logits / temperature
plus the lane's Gumbel noise when sampling) is below ``MARGIN_TOL``.
"""
import numpy as np
import jax
import pytest

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.quant import ptq_quantize_params as jptq
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.dist import TPConfigError
from repro_torch.serve import QueueFullError, ServeConfig, ServingEngine
from repro_torch.serve.kv_pool import PoolExhaustedError

MARGIN_TOL = 0.02
ARCH = "starcoder2-3b"
BASE = dict(batch_lanes=2, max_seq=48, int8_kv=True)
MODES = {
    # mode -> ServeConfig(token_budget, prefill_chunk) overrides, as
    # tests/test_system.py's
    "tokenwise": dict(token_budget=0, prefill_chunk=0),
    "chunked": dict(token_budget=0, prefill_chunk=4),
    "chunked_oneshot": dict(token_budget=0, prefill_chunk=32),
    "packed": dict(token_budget=8),
    "packed_wide": dict(token_budget=32),
}
PROMPTS = [[7, 8, 9, 10, 11, 12, 13, 14, 15], [3, 4, 5],
           [20 + i for i in range(17)], [9, 9, 9, 9, 9]]
SEED = 3


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, precision="w8a8", reduced=True)
    jp = jptq(jinit_params(jax.random.PRNGKey(3), jcfg))
    cfg = get_config(ARCH, precision="w8a8", reduced=True)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def port(model, **kw):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, ServeConfig(**{**BASE, **kw}), device="cpu")


def drain(eng, prompts=PROMPTS, max_new=5, **submit_kw):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i, **submit_kw)
    return {d["id"]: d["tokens"] for d in eng.run_until_drained()}


_CACHE = {}


def port_drain(model, mode, temperature=0.0, **kw):
    key = (mode, temperature, tuple(sorted(kw.items())))
    if key not in _CACHE:
        eng = port(model, temperature=temperature, seed=SEED,
                   **{**MODES[mode], **kw})
        _CACHE[key] = drain(eng)
    return _CACHE[key]


def ref_margin(model, context, temperature, seq):
    """The reference's top-2 margin of the next-token logits after
    ``context`` (one cached prefill: the engine's logits at that position
    are the same by the reference's schedule contract), perturbed by the
    lane's Gumbel noise when sampling (key folded at submission ``seq`` and
    the last fed position)."""
    jcfg, jp = model[:2]
    n = len(context)
    st = jinit_states(jcfg, 1, BASE["max_seq"], int8_kv=True)
    lg, _ = jax.jit(lambda p, t, s: jforward(
        p, jcfg, t, positions=np.arange(n, dtype=np.int32)[None], states=s))(
        jp, np.asarray(context, np.int32)[None], st)
    lg = np.asarray(lg[0, -1])
    if temperature > 0:
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(SEED), seq), n - 1)
        lg = lg / np.float32(temperature) + np.asarray(
            jax.random.gumbel(key, lg.shape))
    top = np.sort(lg)[-2:]
    return float(top[1] - top[0])


# ---------------------------------------------------------------------------
# the three schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("mode", list(MODES))
def test_all_schedules_give_the_same_tokens(model, mode, temperature):
    """Packed (small and wide budget), chunked (small buckets and one-shot)
    and token-at-a-time give IDENTICAL tokens over the int8 KV cache,
    greedy and sampled: a request's stream is keyed by (seed, submission
    id, position) only."""
    got = port_drain(model, mode, temperature)
    assert got == port_drain(model, "tokenwise", temperature)
    assert port(model, **MODES[mode]).mode == mode.split("_")[0]


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("mode", ["tokenwise", "chunked", "packed"])
def test_schedule_matches_the_reference(model, mode, temperature):
    jcfg, jp = model[:2]
    jeng = JServingEngine(jp, jcfg, JServeConfig(
        **{**BASE, **MODES[mode]}, temperature=temperature, seed=SEED))
    want = drain(jeng)
    got = port_drain(model, mode, temperature)
    assert jeng.mode == port(model, **MODES[mode]).mode
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                m = ref_margin(model, PROMPTS[rid] + w[:i], temperature, rid)
                assert m < MARGIN_TOL, (rid, i, a, b, m)
                break
        else:
            assert len(g) == len(w), (rid, g, w)


@pytest.mark.parametrize("kw", [
    dict(token_budget=8), dict(token_budget=24), dict(token_budget=1),
    dict(token_budget=0, prefill_chunk=4), dict(token_budget=0,
                                                prefill_chunk=6),
    dict(token_budget=0, prefill_chunk=0), dict(token_budget=0,
                                                prefill_chunk=1),
    dict(token_budget=8, max_seq=2), dict(token_budget=0, prefill_chunk=8,
                                          max_seq=2),
    dict(token_budget=64, max_seq=40)])
def test_mode_and_buckets_are_the_references(model, kw):
    jcfg, jp = model[:2]
    jeng = JServingEngine(jp, jcfg, JServeConfig(**{**BASE, **kw}))
    eng = port(model, **kw)
    assert (eng.mode, eng.chunk_buckets) == (jeng.mode, jeng.chunk_buckets)
    assert f"mode={eng.mode} " in eng.stats_summary()


@pytest.mark.parametrize("mode", ["tokenwise", "chunked", "packed"])
def test_max_new_exact(model, mode):
    eng = port(model, eos_token=-1, **MODES[mode])
    eng.submit([3, 4, 5, 6], max_new=7)
    assert len(eng.run_until_drained()[0]["tokens"]) == 7


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_max_seq_truncates(model, mode):
    """Requests that cannot fit their decode budget are rejected at submit
    time (nothing enqueued); a legal request beside them drains within the
    sequence budget."""
    eng = port(model, max_seq=16, eos_token=-1,
               **{**MODES[mode], "token_budget": 4 if mode == "packed" else 0})
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([3] * 10, max_new=100, request_id="gen")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([4] * 30, max_new=100, request_id="longprompt")
    assert eng.stats["requests"] == 0
    eng.submit([3] * 10, max_new=5, request_id="legal")
    by_id = {d["id"]: d["tokens"] for d in eng.run_until_drained(500)}
    assert len(by_id) == 1 and 1 <= len(by_id["legal"]) <= 5


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_prompt_exactly_max_seq_minus_two(model, mode):
    def run(m):
        eng = port(model, max_seq=32, eos_token=-1, **MODES[m])
        eng.submit(list(range(2, 32)), max_new=1, request_id=0)
        return eng.run_until_drained(max_iters=500)[0]["tokens"]

    want = run("tokenwise")
    assert len(want) == 1
    assert run(mode) == want
    eng = port(model, max_seq=32, eos_token=-1, **MODES[mode])
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(list(range(2, 33)), max_new=1)


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_prompt_ends_on_bucket_boundary(model, mode):
    def run(m):
        eng = port(model, **MODES[m])
        eng.submit(list(range(10, 18)), max_new=5, request_id=0)  # len 8
        return eng.run_until_drained()[0]["tokens"]

    assert run(mode) == run("tokenwise")


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_tiny_max_seq_degrades_gracefully(model, mode):
    """No multi-token bucket fits below max_seq: chunked demotes to
    tokenwise, packed keeps bucket 1; nothing can be submitted at
    max_seq=2, and max_seq=3 drains one request."""
    eng = port(model, max_seq=2, eos_token=-1, **MODES[mode])
    assert eng.mode == {"chunked": "tokenwise", "packed": "packed"}[mode]
    assert eng.chunk_buckets in ((), (1,))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([3, 4, 5], max_new=4, request_id=0)
    assert eng.run_until_drained(max_iters=5) == []
    eng = port(model, max_seq=3, eos_token=-1, **MODES[mode])
    eng.submit([3], max_new=1, request_id=0)
    done = eng.run_until_drained(max_iters=50)
    assert len(done) == 1 and len(done[0]["tokens"]) == 1


def test_packed_interleaves_decode_in_one_forward(model):
    alone = port(model, token_budget=8)
    alone.submit([7, 8, 9], max_new=8, request_id="a")
    want = alone.run_until_drained()[0]["tokens"]
    eng = port(model, token_budget=8)
    eng.submit([7, 8, 9], max_new=8, request_id="a")
    eng.step()
    eng.submit(list(range(20, 44)), max_new=4, request_id="b")
    by_id = {d["id"]: d["tokens"] for d in eng.run_until_drained()}
    assert by_id["a"] == want and len(by_id["b"]) == 4
    st = eng.stats
    assert sum(st["forwards"].values()) == st["steps"]
    assert any(t > 1 for t in st["forwards"]) and st["decode_tokens"] > 8


def test_chunked_runs_prefill_and_decode_calls(model):
    """Chunked: a co-resident prefill chunk and the decode tokens run as
    two calls of one iteration; the generating lane is undisturbed."""
    alone = port(model, **MODES["chunked"])
    alone.submit([7, 8, 9], max_new=8, request_id="a")
    want = alone.run_until_drained()[0]["tokens"]
    eng = port(model, **MODES["chunked"])
    eng.submit([7, 8, 9], max_new=8, request_id="a")
    eng.step()
    eng.submit(list(range(20, 44)), max_new=4, request_id="b")
    by_id = {d["id"]: d["tokens"] for d in eng.run_until_drained()}
    assert by_id["a"] == want and len(by_id["b"]) == 4
    st = eng.stats
    assert sum(st["forwards"].values()) > st["steps"]   # two calls a step
    assert set(st["forwards"]) == {1, 4} and st["budget_tokens"] == 0


def test_lane_reset_isolation_after_reuse(model):
    eng = port(model, batch_lanes=1, token_budget=8)
    eng.submit(list(range(30, 40)), max_new=6, request_id="long")
    eng.submit([5, 6, 7], max_new=6, request_id="short")
    reused = {d["id"]: d["tokens"] for d in eng.run_until_drained()}
    fresh = port(model, batch_lanes=1, token_budget=8)
    fresh.submit([5, 6, 7], max_new=6, request_id="short")
    assert reused["short"] == fresh.run_until_drained()[0]["tokens"]


def test_eos_terminates_generation(model):
    probe = port(model)
    probe.submit([7, 8, 9, 10], max_new=1)
    first = probe.run_until_drained()[0]["tokens"][0]
    eng = port(model, eos_token=first, **MODES["tokenwise"])
    for i in range(3):
        eng.submit([7, 8, 9, 10], max_new=32, request_id=i)
    done = eng.run_until_drained()
    assert len(done) == 3 and all(d["tokens"] == [first] for d in done)


# ---------------------------------------------------------------------------
# sampling, warmup, run_stream
# ---------------------------------------------------------------------------

def test_per_lane_prng_decorrelated_and_lane_count_invariant(model):
    def run(lanes, n):
        eng = port(model, batch_lanes=lanes, temperature=0.9,
                   token_budget=8, seed=SEED)
        return drain(eng, [[5, 6, 7, 8]] * n, max_new=6)

    two = run(2, 4)
    assert two == run(4, 4)
    assert len({tuple(v) for v in two.values()}) > 1


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("mode", ["tokenwise", "chunked", "packed"])
def test_warmup_does_not_shift_request_streams(model, mode, temperature):
    """warmup() runs every bucket with requests in the reserved key space
    and does not advance the submission counter: serving after it gives
    the tokens of serving without it; stats and finished are cleared."""
    eng = port(model, temperature=temperature, seed=SEED, **MODES[mode])
    eng.warmup()
    assert eng.stats["requests"] == 0 and eng.stats["steps"] == 0
    assert eng.finished == [] and eng._submitted == 0
    assert not eng.lane_active.any()
    assert drain(eng) == port_drain(model, mode, temperature)


def test_warmup_flushes_the_paged_tree(model):
    eng = port(model, temperature=0.9, seed=SEED, paged=True, page_size=4,
               **MODES["packed"])
    eng.warmup()
    assert eng.pool.tree_pages == 0 and eng.pool.free_pages == eng.pool.n - 1
    assert drain(eng) == port_drain(model, "packed", 0.9)
    eng.pool.check()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_run_stream_matches_offline_drain(model, temperature):
    """Arrival timing is measurement plumbing, never a token input: offsets
    0..30 ms give the offline drain's tokens."""
    eng = port(model, temperature=temperature, seed=SEED, **MODES["packed"])
    sched = [(0.01 * i, dict(prompt=p, max_new=5, request_id=i))
             for i, p in enumerate(PROMPTS)]
    done, rejected = eng.run_stream(sched)
    assert rejected == []
    assert ({d["id"]: d["tokens"] for d in done}
            == port_drain(model, "packed", temperature))


def test_run_stream_collects_rejections(model):
    eng = port(model, queue_limit=1, **MODES["packed"])
    sched = [(0.0, dict(prompt=p, max_new=2, request_id=i))
             for i, p in enumerate(PROMPTS)]
    done, rejected = eng.run_stream(sched)
    assert rejected and len(done) + len(rejected) == len(PROMPTS)
    assert eng.stats["rejected"] == len(rejected)
    with pytest.raises(QueueFullError):
        full = port(model, queue_limit=1)
        full.submit([3, 4], max_new=2)
        full.submit([3, 5], max_new=2)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_on_token_streams_in_commit_order(model, spec_k):
    eng = port(model, token_budget=8, spec_k=spec_k)
    seen = []
    eng.submit([3, 4, 5, 3, 4, 5, 3, 4], max_new=9, request_id="s",
               on_token=lambda rid, tok: seen.append((rid, tok)))
    done = eng.run_until_drained()
    assert [t for _, t in seen] == done[0]["tokens"]
    assert all(rid == "s" for rid, _ in seen)


@pytest.mark.parametrize("mode", ["chunked", "packed"])
def test_paged_matches_dense_sampled(model, mode):
    eng = port(model, temperature=0.9, seed=SEED, paged=True, page_size=4,
               **MODES[mode])
    assert drain(eng) == port_drain(model, mode, 0.9)


def test_pressure_drain_matches_unconstrained_sampled(model):
    """A tiny pool preempts and swaps lanes; a resumed lane refolds its
    submission key, so the sampled tokens equal the unconstrained run's."""
    prompts = [[10 + (i * 7 + j) % 90 for j in range(14 + (i * 5) % 22)]
               for i in range(6)]
    kw = dict(paged=True, page_size=8, temperature=0.9, seed=SEED,
              token_budget=8)
    want = drain(port(model, **kw), prompts)
    eng = port(model, pool_pages=8, **kw)
    assert drain(eng, prompts) == want
    m = eng.serving_metrics()
    assert m["preemptions"] >= 1 and m["resumes"] >= 1
    eng.pool.check()


def test_swap_off_surfaces_pool_exhaustion(model):
    prompts = [[10 + (i * 7 + j) % 90 for j in range(30)] for i in range(2)]
    eng = port(model, paged=True, page_size=8, pool_pages=8, swap=False,
               token_budget=8)
    with pytest.raises(PoolExhaustedError):
        drain(eng, prompts, max_new=8)


def test_serve_config_fields_and_validation(model):
    import dataclasses
    fields = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(JServeConfig)}
    assert fields == jfields
    with pytest.raises(ValueError, match="tp_overlap"):
        port(model, tp_overlap="sideways")
    # tp > 1 outside a TP group (no mesh) is refused with the port's error
    with pytest.raises(TPConfigError, match="TP group of 2 ranks"):
        port(model, tp=2)


@pytest.mark.parametrize("argv,want", [
    (["--token-budget", "0", "--prefill-chunk", "4"], "mode=chunked"),
    (["--token-budget", "0", "--prefill-chunk", "0", "--temperature", "0.7"],
     "mode=tokenwise"),
    (["--spec-k", "3"], "mode=packed"),
    (["--stream-gap-ms", "2", "--temperature", "0.7"], "ttft p50/p99")])
def test_launcher_cpu_schedules(capsys, argv, want):
    from repro_torch.launch.serve import main
    main(["--arch", "starcoder2-3b", "--reduced", "--w8a8", "--int8-kv",
          "--requests", "3", "--max-new", "4", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and want in out
