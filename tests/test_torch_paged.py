"""Paged KV serving in the port against the JAX reference, on the CPU.

* the plain ``paged_decode_attention_ref`` against ``jax.jit`` of
  ``repro.kernels.ref.paged_decode_attention_ref`` and the Pallas kernel in
  interpret mode (int8 and bf16 pages, GQA and MHA, a window, null entries,
  a physical page two lanes share, slots cleared by copy-on-write, an idle
  lane): within ``2e-5`` with an f32 query (the dense decode test's), one
  bf16 ulp with a bf16 query;
* the paged cache functions (``_write_paged``, ``_read_paged``,
  ``gather_pages``, ``scatter_pages``) bit-exact against the jitted
  reference's on the same arena;
* the port's paged engine against its dense engine (greedy tokens equal,
  with prefix reuse and under preempt/swap) and against the reference's
  paged engine (greedy tokens; divergence only at a near-tie, as in
  ``test_torch_serve.py``).

The CUDA kernel itself is held against the plain version and the dense
kernel by the ``cuda``-marked test at the end (skipped without a card) and
by ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref
from repro.kernels.paged_attention import paged_decode_attention as pallas_paged
from repro.models import attention as jattn
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
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_decode_attention_ref
from repro_torch.models import attention as tattn
from repro_torch.models import init_params
from repro_torch.models.config import ArchConfig
from repro_torch.quant import (DEFAULT_W4_POLICY, ptq_quantize_params,
                               quantize_for)
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.kv_pool import PoolExhaustedError

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULP = dict(rtol=2.0 ** -7, atol=2e-5)


def T(a):
    return torch.from_numpy(np.array(a))


def bits(x) -> np.ndarray:
    """Raw bits of a port tensor or a jax array (bf16 as its 16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint8)


def same_bits(port, jx) -> bool:
    a, b = bits(port), bits(jx)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the plain kernel version
# ---------------------------------------------------------------------------

NPG, PS, MP = 12, 8, 4
IDLE = 2


def arena(rng, hkv, d, int8):
    """Random payload in every page, so that cleared and unmapped slots hold
    stale data the mask must hide.  int8 pages hold normal K/V quantized per
    (token, head) as the cache write quantizes them (``amax / 127``), as in
    the dense decode test."""
    shape = (NPG, PS, hkv, d)
    if int8:
        out = []
        for _ in range(2):
            x = rng.normal(size=shape).astype(np.float32)
            s = (np.abs(x).max(-1, keepdims=True) / 127.0).astype(np.float32)
            out += [np.clip(np.round(x / s), -128, 127).astype(np.int8), s]
        return tuple(out)
    pk, pv = (np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
              for _ in range(2))
    return pk, None, pv, None


def tables():
    """Four lanes: lane 0 a chain whose last page is half filled; lane 1
    shares lane 0's first physical page and owns a page copied on write
    (keep 3); lane 2 idle (qpos -1, all-null table); lane 3 with a null
    entry between two pages that are not adjacent."""
    ppos = np.full((NPG, PS), -1, np.int32)
    pt = np.zeros((4, MP), np.int32)
    pt[0] = [1, 2, 3, 0]
    for j, pid in enumerate([1, 2, 3]):
        ppos[pid] = np.arange(j * PS, (j + 1) * PS)
    ppos[3, PS // 2:] = -1
    pt[1] = [1, 5, 0, 0]
    ppos[5, :3] = np.arange(PS, PS + 3)
    pt[3] = [9, 0, 6, 0]
    ppos[9] = np.arange(PS)
    ppos[6] = np.arange(2 * PS, 3 * PS)
    qpos = np.array([2 * PS + PS // 2 - 1, PS + 2, -1, 3 * PS - 1], np.int32)
    return ppos, pt, qpos


def kernel_inputs(rng, hq, hkv, d=32, int8=True):
    pk, pks, pv, pvs = arena(rng, hkv, d, int8)
    ppos, pt, qpos = tables()
    q = rng.normal(size=(4, hq, d)).astype(np.float32)
    return q, pk, pks, pv, pvs, ppos, pt, qpos


def to_port(q, pk, pks, pv, pvs, ppos, pt, qpos, qdtype):
    def tt(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return T(a.astype(np.float32)).to(torch.bfloat16)
        return T(a)
    return (T(q).to(qdtype), tt(pk), tt(pks), tt(pv), tt(pvs), T(ppos),
            T(pt), T(qpos))


def to_jax(q, pk, pks, pv, pvs, ppos, pt, qpos, qdtype):
    def jj(a):
        return None if a is None else jnp.asarray(a)
    return (jnp.asarray(q, qdtype), jj(pk), jj(pks), jj(pv), jj(pvs),
            jnp.asarray(ppos), jnp.asarray(pt), jnp.asarray(qpos))


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


HEADS = [(8, 2), (2, 2)]


class TestPlainPagedAttention:
    @pytest.mark.parametrize("int8", [True, False])
    @pytest.mark.parametrize("hq,hkv", HEADS, ids=["gqa", "mha"])
    @pytest.mark.parametrize("window", [0, 9])
    def test_close_vs_jit_ref(self, rng, int8, hq, hkv, window):
        x = kernel_inputs(rng, hq, hkv, int8=int8)
        want = jax.jit(lambda *a: ref.paged_decode_attention_ref(
            *a, window=window))(*to_jax(*x, jnp.float32))
        got = paged_decode_attention_ref(*to_port(*x, torch.float32),
                                         window=window)
        np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
        assert (as_f32(got)[IDLE] == 0).all()

    @pytest.mark.parametrize("int8", [True, False])
    @pytest.mark.parametrize("hq,hkv", HEADS, ids=["gqa", "mha"])
    @pytest.mark.parametrize("window", [0, 9])
    def test_close_vs_pallas_interpret(self, rng, int8, hq, hkv, window):
        x = kernel_inputs(rng, hq, hkv, int8=int8)
        want = pallas_paged(*to_jax(*x, jnp.float32), window=window,
                            interpret=True)
        got = ops.paged_attention_decode(*to_port(*x, torch.float32),
                                         window=window)
        np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
        assert (as_f32(got)[IDLE] == 0).all()

    @pytest.mark.parametrize("int8", [True, False])
    def test_bf16_query_within_one_ulp(self, rng, int8):
        x = kernel_inputs(rng, 8, 2, int8=int8)
        want = jax.jit(ref.paged_decode_attention_ref)(
            *to_jax(*x, jnp.bfloat16))
        got = paged_decode_attention_ref(*to_port(*x, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(as_f32(got), as_f32(want), **BF16_ULP)

    def test_window_excluding_every_slot_emits_zeros(self, rng):
        q, pk, pks, pv, pvs, ppos, pt, _ = kernel_inputs(rng, 8, 2)
        qpos = np.array([100, 100, -1, 100], np.int32)
        got = paged_decode_attention_ref(*to_port(
            q, pk, pks, pv, pvs, ppos, pt, qpos, torch.float32), window=4)
        assert (got == 0).all()

    def test_shared_page_reads_the_same_keys(self, rng):
        """Lanes 0 and 1 name the same physical page for positions 0..7:
        with the same query and qpos inside that page, they agree exactly."""
        q, pk, pks, pv, pvs, ppos, pt, _ = kernel_inputs(rng, 8, 2)
        q[1] = q[0]
        qpos = np.array([5, 5, -1, 5], np.int32)
        got = paged_decode_attention_ref(*to_port(
            q, pk, pks, pv, pvs, ppos, pt, qpos, torch.float32))
        assert torch.equal(got[0], got[1])


# ---------------------------------------------------------------------------
# the paged cache functions, bit-exact against the jitted reference
# ---------------------------------------------------------------------------

CFG = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=4, vocab_size=8, d_head=16)


def cache_pair(rng, int8, b=2, npg=10, ps=8, mp=4):
    """The same arena as a reference dict and a port dict: random stale
    payload, some positions, a page table with a null entry."""
    jc = jattn.init_paged_cache(ArchConfig(**CFG), b, npg, ps, mp, int8=int8)
    host = {k: np.array(v) for k, v in jc.items()}
    shape = host["pk"].shape
    if int8:
        host["pk"] = rng.integers(-127, 128, shape).astype(np.int8)
        host["pks"] = np.abs(rng.normal(size=(*shape[:3], 1))).astype(
            np.float32)
    else:
        host["pk"] = np.asarray(jnp.asarray(rng.normal(size=shape),
                                            jnp.bfloat16))
    host["ppos"][4, :3] = [0, 1, 2]
    host["pt"][0] = [4, 2, 0, 7]                 # logical 2 is the null page
    host["pt"][1] = [3, 5, 6, 0]
    jc = {k: jnp.asarray(v) for k, v in host.items()}
    tc = {}
    for k, v in host.items():
        tc[k] = (T(v.astype(np.float32)).to(torch.bfloat16)
                 if v.dtype == jnp.bfloat16 else T(v))
    return jc, tc


def kv_batch(rng, b=2, t=12, hkv=2, d=16):
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32) * 3
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    pos = np.tile(np.arange(8, 8 + t, dtype=np.int32), (b, 1))
    pos[0, -3:] = -1                             # pads
    pos[1, :2] = -1
    return k, v, pos


def jbf(a):
    return jnp.asarray(a, jnp.bfloat16)


def tbf(a):
    return T(a).to(torch.bfloat16)


class TestPagedRows:
    """The paged multi-row form (the rows of a packed t > 1 step, ROADMAP
    C3)."""

    def _rows(self, rng, int8, t=4):
        q, pk, pks, pv, pvs, ppos, pt, qpos = kernel_inputs(rng, 8, 2,
                                                            int8=int8)
        qr = rng.normal(size=(4, t, 8, q.shape[-1])).astype(np.float32)
        qp = (qpos[:, None] - np.arange(t)[::-1][None]).astype(np.int32)
        qp[IDLE] = -1
        qp[0, 0] = -1                              # a pad row
        return (T(qr).to(torch.bfloat16),) + to_port(
            q, pk, pks, pv, pvs, ppos, pt, qpos, torch.bfloat16)[1:7] + (
                T(qp),)

    @pytest.mark.parametrize("int8", [True, False])
    def test_rows_equal_single_row_launches(self, rng, int8):
        """Row i of the multi-row plain version is the T = 1 plain version
        at that row's position, bit for bit; idle rows are exact zeros."""
        qr, *args, qp = self._rows(rng, int8)
        got = ops.paged_attention_decode_rows(qr, *args, qp)
        assert got.shape == qr.shape and got.dtype == torch.bfloat16
        for i in range(qr.shape[1]):
            one = ops.paged_attention_decode(qr[:, i], *args,
                                             qp[:, i].contiguous())
            assert torch.equal(got[:, i], one)
        assert (got[IDLE] == 0).all() and (got[0, 0] == 0).all()

    def test_rows_close_vs_jit_ref(self, rng):
        qr, *args, qp = self._rows(rng, True)
        got = ops.paged_attention_decode_rows(qr.float(), *args, qp)
        jargs = [jnp.asarray(a.numpy()) for a in args]
        f = jax.jit(lambda q, qpos: ref.paged_decode_attention_ref(
            q, *jargs, qpos))
        for i in range(qr.shape[1]):
            want = f(jnp.asarray(qr[:, i].float().numpy()),
                     jnp.asarray(qp[:, i].numpy()))
            np.testing.assert_allclose(got[:, i].numpy(), as_f32(want), **TOL)


@pytest.mark.parametrize("int8", [True, False])
class TestPagedCacheFunctions:
    def test_write_paged_bit_exact(self, rng, int8):
        jc, tc = cache_pair(rng, int8)
        k, v, pos = kv_batch(rng)
        want = jax.jit(jattn._write_paged)(jc, jbf(k), jbf(v),
                                           jnp.asarray(pos))
        got = tattn._write_paged(tc, tbf(k), tbf(v), T(pos))
        for key in want:
            assert same_bits(got[key], want[key]), key
        # positions 16..23 of lane 0 map to the null page: dropped
        assert (got["ppos"][0] == -1).all()

    def test_cache_writes_drop_pads_and_null_pages(self, rng, int8):
        _, tc = cache_pair(rng, int8)
        _, _, pos = kv_batch(rng)
        b_idx, t_idx, phys, slot = tattn.cache_writes(T(pos), tc)
        p = T(pos)[b_idx, t_idx]
        assert (p >= 0).all() and (phys > 0).all()
        assert torch.equal(phys, tc["pt"][b_idx, p // 8].long())
        assert torch.equal(slot, p.long() % 8)
        # lane 0: 9 real tokens at 8..16, the one at 16 lands on the null page
        assert int((b_idx == 0).sum()) == 8

    @pytest.mark.parametrize("dtype", ["bf16", "f32"])
    def test_read_paged_bit_exact(self, rng, int8, dtype):
        jc, tc = cache_pair(rng, int8)
        k, v, pos = kv_batch(rng)
        jc = jax.jit(jattn._write_paged)(jc, jbf(k), jbf(v), jnp.asarray(pos))
        tc = tattn._write_paged(tc, tbf(k), tbf(v), T(pos))
        jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                  else (jnp.float32, torch.float32))
        want = jax.jit(lambda c: jattn._read_paged(c, jd))(jc)
        got = tattn._read_paged(tc, td)
        for g, w in zip(got, want):
            assert same_bits(g, w)

    def test_gather_scatter_bit_exact_and_round_trip(self, rng, int8):
        jc, tc = cache_pair(rng, int8)
        src, dst = [3, 4, 7], [8, 9, 1]
        want = jattn.gather_pages(jc, jnp.asarray(src, jnp.int32))
        got = tattn.gather_pages(tc, src)
        assert sorted(got) == sorted(want)
        for key in want:
            assert same_bits(got[key], want[key]), key
        # scatter into other pages (page 1 was one of the sources)
        jw = jax.jit(jattn.scatter_pages)(jc, jnp.asarray(dst, jnp.int32),
                                          want)
        tw = tattn.scatter_pages(tc, dst, got)
        for key in jw:
            assert same_bits(tw[key], jw[key]), key
        back = tattn.gather_pages(tw, dst)
        for key in got:
            assert torch.equal(back[key], got[key]), key

    def test_init_paged_cache_matches_reference(self, rng, int8):
        want = jattn.init_paged_cache(ArchConfig(**CFG), 3, 9, 4, 5, int8=int8)
        got = tattn.init_paged_cache(ArchConfig(**CFG), 3, 9, 4, 5, int8=int8,
                                     device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            assert same_bits(got[key], want[key]), key
        # page axis 0 on every leaf gather_pages/scatter_pages index
        assert all(got[k].shape[0] == 9 for k in tattn._PAGE_KEYS if k in got)


def test_layers_share_one_page_table():
    from repro_torch.models import init_states
    cfg = get_config("starcoder2-3b", reduced=True)
    st = init_states(cfg, 2, 32, int8_kv=True, device="cpu", paged_pages=9,
                     page_size=8)
    pts = {id(s["kv"]["pt"]) for s in st}
    assert len(st) > 1 and len(pts) == 1
    assert tuple(st[0]["kv"]["pt"].shape) == (2, 4)


# ---------------------------------------------------------------------------
# the port's paged engine against its dense engine
# ---------------------------------------------------------------------------

PROMPTS = [[7, 8, 9, 10, 11, 12, 13, 14, 15], [3, 4, 5],
           [20 + i for i in range(17)], [9, 9, 9, 9, 9]]
LONG = [[10 + (i * 7 + j) % 90 for j in range(14 + (i * 5) % 22)]
        for i in range(6)]
MODELS = {
    "starcoder-bf16kv": ("starcoder2-3b", "bf16", False),
    "starcoder-int8kv": ("starcoder2-3b", "bf16", True),
    "codeqwen-w4a8-int8kv": ("codeqwen1.5-7b", "w4a8", True),
}
_PARAMS = {}


def model(name):
    arch, precision, int8_kv = MODELS[name]
    if (arch, precision) not in _PARAMS:
        cfg = get_config(arch, precision=precision, reduced=True)
        _PARAMS[arch, precision] = (cfg, quantize_for(
            init_params(cfg, seed=3, device="cpu"), precision))
    cfg, params = _PARAMS[arch, precision]
    return cfg, params, int8_kv


def engine(name, paged, **kw):
    cfg, params, int8_kv = model(name)
    kw.setdefault("batch_lanes", 2)
    kw.setdefault("max_seq", 48)
    kw.setdefault("token_budget", 8)
    return ServingEngine(params, cfg, ServeConfig(paged=paged, int8_kv=int8_kv,
                                                  **kw), device="cpu")


def drain(eng, prompts, max_new=5, **submit_kw):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i, **submit_kw)
    return {d["id"]: d["tokens"] for d in eng.run_until_drained()}


@pytest.mark.parametrize("name", list(MODELS))
class TestPagedEngine:
    def test_paged_matches_dense_greedy(self, name):
        want = drain(engine(name, False), PROMPTS)
        eng = engine(name, True)
        ops.reset_launch_counts()
        assert drain(eng, PROMPTS) == want
        assert eng.paged and eng.pool.ps == 16
        assert ops.launch_counts()["paged_decode_attention"] == 0  # CPU
        eng.pool.check()

    def test_prefix_reuse_skips_prefill_and_stays_exact(self, name):
        pre = list(range(30, 54))
        reqs = [pre + [5, 6], pre + [9, 9, 9]]

        def run(eng):
            for i, p in enumerate(reqs):      # sequential: 2nd sees 1st's tree
                eng.submit(p, max_new=4, request_id=i)
                eng.run_until_drained()
            return {d["id"]: d["tokens"] for d in eng.finished}

        dense = engine(name, False, max_seq=64)
        paged = engine(name, True, max_seq=64)
        assert run(paged) == run(dense)
        assert paged.pool.stats["prefix_hit_tokens"] > 0
        assert paged.stats["prompt_tokens"] < dense.stats["prompt_tokens"]
        assert paged.pool.stats["cow_copies"] >= 1
        paged.pool.check()
        assert "paged[page=16 hits=1" in paged.stats_summary()

    def test_pressure_drain_matches_unconstrained(self, name):
        """A pool of mp + 2 pages for 2 lanes: the drain preempts, swaps KV
        to host memory, resumes, and gives exactly the unconstrained
        tokens."""
        want = drain(engine(name, False), LONG)
        eng = engine(name, True, page_size=8, pool_pages=8)   # mp = 6
        assert drain(eng, LONG) == want
        m = eng.serving_metrics()
        assert m["preemptions"] >= 1 and m["resumes"] >= 1
        assert m["swap_out_pages"] == m["swap_in_pages"] >= 1
        assert "overload[preempt=" in eng.stats_summary()
        eng.pool.check()
        eng._apply_pool_actions(eng.pool.flush_tree())
        assert eng.pool.free_pages == eng.pool.n - 1


def test_identical_prompt_shares_all_full_pages():
    prompt = list(range(40, 72))                  # exactly 2 pages of 16
    eng = engine("starcoder-int8kv", True, max_seq=64)
    for rid in ("a", "b"):
        eng.submit(prompt, max_new=4, request_id=rid)
        eng.run_until_drained()
    by_id = {d["id"]: d["tokens"] for d in eng.finished}
    assert by_id["a"] == by_id["b"]
    assert eng.pool.stats["prefix_hit_tokens"] == len(prompt) - 1


def test_lane_reuse_isolation():
    eng = engine("starcoder-int8kv", True, batch_lanes=1)
    eng.submit(list(range(30, 40)), max_new=6, request_id="long")
    eng.submit([5, 6, 7], max_new=6, request_id="short")
    reused = {d["id"]: d["tokens"] for d in eng.run_until_drained()}
    fresh = engine("starcoder-int8kv", True, batch_lanes=1)
    fresh.submit([5, 6, 7], max_new=6, request_id="short")
    assert reused["short"] == fresh.run_until_drained()[0]["tokens"]


def test_victim_is_lowest_priority():
    eng = engine("starcoder-bf16kv", True, page_size=8, pool_pages=8)
    eng.submit([11 + i % 80 for i in range(30)], max_new=6, request_id="lo",
               priority=0)
    eng.submit([90 + i % 60 for i in range(30)], max_new=6, request_id="hi",
               priority=3)
    done = eng.run_until_drained()
    assert {d["id"] for d in done} == {"lo", "hi"}
    assert eng.serving_metrics()["preemptions"] >= 1
    assert set(eng.stats["preempted_requests"]) == {"lo"}


def test_dense_engine_never_preempts():
    eng = engine("starcoder-bf16kv", False)
    assert len(drain(eng, LONG)) == len(LONG)
    assert eng.serving_metrics()["preemptions"] == 0 and eng.pool is None


def test_lone_lane_surfaces_pool_exhaustion():
    """When the pool cannot back even the last active lane, no victim is
    left to preempt and PoolExhaustedError surfaces where the reference
    raises, instead of serving on.  A legal pool (>= mp + 2 pages) always
    fits a lone lane, so this pool refuses every reservation."""
    eng = engine("starcoder-bf16kv", True, page_size=8)

    def refuse(lane, pos0, count):
        raise PoolExhaustedError([])
    eng.pool.ensure_writable = refuse
    with pytest.raises(PoolExhaustedError):
        drain(eng, LONG[:2])
    assert eng.stats["preemptions"] == 1        # the other lane went first
    assert eng.stats["preempted_requests"] == [0]


def test_page_size_demoted_to_divide_max_seq():
    eng = engine("starcoder-bf16kv", True, max_seq=48, page_size=32)
    assert (eng.pool.ps, eng.pool.mp, eng.pool.n) == (24, 2, 4 * 2 + 1)
    assert tuple(eng._pt.shape) == (2, 2)


def test_launcher_cpu_paged(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "codeqwen1.5-7b", "--reduced", "--w4a8", "--int8-kv",
          "--paged", "--requests", "3", "--max-new", "3", "--lanes", "2",
          "--max-seq", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "paged[page=16" in out
    assert "paged pool: 17 pages of 16 slots" in out      # (2 + 2) * 4 + 1
    assert "preemptions=0" in out


# ---------------------------------------------------------------------------
# the port's paged engine against the reference's
# ---------------------------------------------------------------------------

MARGIN_TOL = 0.02
SCFG = dict(batch_lanes=3, max_seq=64, int8_kv=True, token_budget=8,
            paged=True, page_size=16)


def jax_margin(jcfg, jp, context):
    """The reference's top-2 margin of the next-token logits after
    ``context`` (one cached prefill)."""
    st = jinit_states(jcfg, 1, SCFG["max_seq"], int8_kv=True)
    n = len(context)
    lg, _ = jax.jit(lambda p, t, s: jforward(
        p, jcfg, t, positions=np.arange(n, dtype=np.int32)[None], states=s))(
        jp, np.asarray(context, np.int32)[None], st)
    top = np.sort(np.asarray(lg[0, -1]))[-2:]
    return float(top[1] - top[0])


def reference_pair(arch):
    """The reference's float weights, PTQ'd by each side with the launcher's
    policy (bit-identical trees), and fixed-seed prompts of which two share
    a 20-token prefix (a prefix hit on both sides)."""
    precision = "w8a8" if arch == "starcoder2-3b" else "w4a8"
    jcfg = jget_config(arch, precision=precision, reduced=True)
    jf = jinit_params(jax.random.PRNGKey(5), jcfg)
    cfg = get_config(arch, precision=precision, reduced=True)
    tp = from_reference(jax.device_get(jf), cfg, device="cpu")
    if precision == "w4a8":
        tp = ptq_quantize_params(tp, policy=DEFAULT_W4_POLICY)
        jp = jptq(jf, policy=J_W4_POLICY)
    else:
        tp = ptq_quantize_params(tp)
        jp = jptq(jf)
    rng = np.random.default_rng(11)
    pre = rng.integers(2, cfg.vocab_size, 20).tolist()
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 12, 2)]
    prompts += [pre + [3, 4], pre + [9]]
    return jcfg, jp, cfg, tp, prompts


@pytest.mark.parametrize("arch", ["starcoder2-3b", "codeqwen1.5-7b"])
def test_paged_greedy_tokens_match_reference(arch):
    jcfg, jp, cfg, tp, prompts = reference_pair(arch)

    def run(eng):
        # the shared-prefix pair goes after the first three have drained,
        # so that its first prompt's pages are registered
        out = {}
        for wave in (range(4), range(4, 5)):
            for i in wave:
                eng.submit(prompts[i], max_new=8, request_id=i)
            out.update({r["id"]: r["tokens"] for r in eng.run_until_drained()})
        return out, eng

    ref_tok, jeng = run(JServingEngine(jp, jcfg, JServeConfig(**SCFG)))
    mine, teng = run(ServingEngine(tp, cfg, ServeConfig(**SCFG), device="cpu"))
    assert teng.pool.stats["prefix_hit_tokens"] == jeng.pool.stats[
        "prefix_hit_tokens"] > 0
    assert sorted(mine) == sorted(ref_tok)
    for rid, want in ref_tok.items():
        got = mine[rid]
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                m = jax_margin(jcfg, jp, prompts[rid] + want[:i])
                assert m < MARGIN_TOL, (rid, i, a, b, m)
                break
        else:
            assert len(got) == len(want), (rid, got, want)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card (chip_smoke.py covers them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
def test_paged_rows_on_card(rng, cuda_dev, int8):
    """The paged multi-row form on the card: each row bit-equal to a T = 1
    launch at its position with the same B."""
    qr, *args, qp = [None if a is None else a.to(cuda_dev)
                     for a in TestPagedRows()._rows(rng, int8, t=20)]
    got = ops.paged_attention_decode_rows(qr, *args, qp)
    for i in range(qr.shape[1]):
        one = ops.paged_attention_decode(qr[:, i].contiguous(), *args,
                                         qp[:, i].contiguous())
        assert torch.equal(got[:, i], one)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
def test_paged_kernel_on_card(rng, cuda_dev, int8):
    from repro_torch.kernels.int8_kv_decode_attention import ATOL, RTOL
    x = to_port(*kernel_inputs(rng, 8, 2, d=128, int8=int8), torch.bfloat16)
    args = [None if a is None else a.to(cuda_dev) for a in x]
    for window in (0, 9):
        got = ops.paged_attention_decode(*args, window=window)
        want = paged_decode_attention_ref(*args, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                                   atol=ATOL)
        assert (got[IDLE] == 0).all()
        if int8:
            q, pk, pks, pv, pvs, ppos, pt, qpos = args
            ptc = pt.long()

            def view(a):
                return a[ptc].reshape(4, MP * PS, *a.shape[2:]).contiguous()
            dense = ops.decode_attention_int8kv(
                q, view(pk), view(pks), view(pv), view(pvs),
                ppos[ptc].reshape(4, -1).contiguous(), qpos, window=window)
            live = [0, 1, 3]
            assert torch.equal(got[live], dense[live])
