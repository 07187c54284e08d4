"""The port's mixture-of-experts path on the CPU against the JAX reference
(``repro.models.moe``), at mixtral-8x7b-reduced (4 experts top-2, window
32) and qwen2-moe-a2.7b-reduced (4 experts top-2 plus a sigmoid-gated
shared expert, qkv bias, tied embeddings), with the reference's own weights
(``convert.py``).

* ``_group_size`` and ``moe_capacity`` equal the reference's over T in
  {8, 16, 256, 2048, 4096} for both full-width configs and the reduced ones
  (both packages on the cost-model table: ``REPRO_AUTOTUNE_CACHE`` points at
  a missing file).
* ``_dispatch_combine``: the dispatch and combine tensors and the kept
  choices equal the reference's bit for bit, on random rows, rows of equal
  probabilities (``jax.lax.top_k`` takes the lower index first; so does
  the port's stable sort) and a group past capacity.
* ``moe()`` at bf16, w8a8 and w4a8 with an expert that receives no token:
  integer results bit-equal (``INT_TOL`` = 0), bf16 within ``BF16_TOL``
  (the reference's own MoE bound, ``tests/test_models.py:98-101``).  The
  reference is compiled with ``xla_allow_excess_precision`` off (``EXACT``):
  by default XLA:CPU keeps the combine's f32 sum unrounded into the shared
  expert's add, which the port (as a TPU) rounds to bf16.
* The expert-batched GEMM forms' plain versions equal the unbatched plain
  versions expert by expert.
* ``init_params(..., precision=...)`` (a block at a time) is bit-equal to
  ``quantize_for`` of the whole float model; PTQ of the converted float
  model equals the reference's PTQ; the MoE layout converts both ways.
* The reduced models' ``forward`` (no cache, and a cached prefill plus
  decode steps over bf16 and int8 KV caches) and ``lm_loss`` against
  ``jax.jit``: integer precisions within ``W8A8_TOL`` (the bound of
  ``test_torch_models.py``: every integer kernel is bit-exact, but the
  windowed and cached attention is float glue (``_sdpa``) that can move one
  int8 activation level; the no-cache logits come out equal), bf16 within
  ``BF16_TOL``.  At bf16 a float rounding of the router's
  input can flip a top-k choice at a near-tie (qwen2-moe-reduced, seed 1:
  one position moved by 0.2; seed 3: one by 0.07, at a gap of 3e-4 to
  1e-3); so at bf16 the tokens whose k-th and (k+1)-th router probabilities
  lie within ``NEAR_TIE`` in some layer (``near_ties``) are left out of
  the comparison (a flip there reaches the other tokens only through the
  next layers' attention, diluted), and at least ``MIN_COMPARED`` of the
  positions must be compared.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import costmodel as jcost
from repro.kernels import autotune as jautotune
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.models import lm_loss as jlm_loss
from repro.models import moe as jmoe
from repro.models.layers import ExecMode as JExecMode
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY

from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import costmodel
from repro_torch.kernels import int8_gemm as ig
from repro_torch.kernels import quantize as kq
from repro_torch.models import forward, init_params, init_states, lm_loss
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ExecMode
from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
from repro_torch.quant.ptq import quantize_for

ARCHS = ("mixtral-8x7b", "qwen2-moe-a2.7b")
PRECISIONS = ("bf16", "w8a8", "w4a8")
INT_TOL = 0.0
W8A8_TOL = 0.02
BF16_TOL = 0.02
EXACT = {"xla_allow_excess_precision": False}
T_SWEEP = (8, 16, 256, 2048, 4096)
NEAR_TIE = 1e-3
MIN_COMPARED = 0.75


def T(a):
    return torch.from_numpy(np.array(a))


def as_np(x):
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def tree_equal(a, b) -> bool:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(np.asarray(x).dtype == np.asarray(y).dtype
                            and np.array_equal(np.asarray(x), np.asarray(y))
                            for x, y in zip(la, lb))


@pytest.fixture(autouse=True, scope="module")
def table_path():
    """Both packages on the cost-model table: the reference's measured
    cache points at a file that does not exist."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", "/nonexistent/repro-autotune.json")
    jautotune.reset_measured_cache()
    jautotune.moe_group_size.cache_clear()
    yield
    mp.undo()
    jautotune.reset_measured_cache()
    jautotune.moe_group_size.cache_clear()


def _quantize_ref(p, prec):
    if prec == "w8a8":
        return jptq(p)
    if prec == "w4a8":
        return jptq(p, policy=J_W4_POLICY)
    return p


@pytest.fixture(scope="module")
def trees():
    """{(arch, precision): (jax params, numpy tree)} of the reduced models,
    seed 0; the integer ones PTQ'd by the reference."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch, reduced=True)
        jf = jinit_params(jax.random.PRNGKey(0), jcfg)
        for prec in PRECISIONS:
            p = _quantize_ref(jf, prec)
            out[arch, prec] = (p, jax.device_get(p))
    return out


# ---------------------------------------------------------------------------
# group size and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", T_SWEEP)
@pytest.mark.parametrize("arch", ARCHS)
def test_group_size_and_capacity(arch, t):
    for reduced in (False, True):
        jcfg = jget_config(arch, reduced=reduced)
        cfg = get_config(arch, reduced=reduced)
        sg = tmoe._group_size(cfg, t)
        assert sg == jmoe._group_size(jcfg, t)
        e, k = cfg.n_experts, cfg.n_experts_per_tok
        assert costmodel.moe_capacity(sg, e, k, cfg.capacity_factor) == \
            jcost.moe_capacity(sg, e, k, jcfg.capacity_factor)
        ff = cfg.moe_d_ff or cfg.d_ff
        for cand in (128, 1024, t):
            assert costmodel.moe_dispatch_cost(
                t, cfg.d_model, ff, e, k, cfg.capacity_factor, cand) == \
                jcost.moe_dispatch_cost(t, jcfg.d_model, ff, e, k,
                                        jcfg.capacity_factor, cand)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _probs(case, rng, g, s, e):
    logits = rng.standard_normal((g, s, e)).astype(np.float32)
    if case == "ties":
        logits[:, ::3] = 0.0            # every third token: all equal
        logits[0, 1, : e // 2] = 1.5    # a tie among the leading experts
    if case == "over_capacity":
        logits[:, :, 1] += 6.0          # most tokens pick expert 1 first
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("k,e", [(2, 8), (4, 60)])
@pytest.mark.parametrize("case", ["random", "ties", "over_capacity"])
def test_dispatch_combine(case, k, e, rng):
    g, s = 2, 24
    cap = jcost.moe_capacity(s, e, k, 1.25)
    probs = _probs(case, rng, g, s, e)
    jd, jc = jax.jit(jmoe._dispatch_combine, static_argnums=(1, 2))(
        jnp.asarray(probs), k, cap)
    td, tc = tmoe._dispatch_combine(T(probs), k, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    # the kept choices: as many as the dispatch holds, drops where expected
    _, _, keep, _ = tmoe._route(T(probs), k, cap)
    assert int(keep.sum()) == int(np.asarray(jd).sum())
    if case == "over_capacity":
        assert not bool(keep.all())
    if case == "ties":
        top = np.asarray(jax.lax.top_k(jnp.asarray(probs), k)[1])
        idx, _, _, _ = tmoe._route(T(probs), k, cap)
        assert np.array_equal(idx.numpy(), top)
        assert np.array_equal(top[0, 0], np.arange(k))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer(trees, arch, prec):
    """moe() of the first layer's parameters on 3 x 8 tokens whose rows are
    positive, with expert 0's router column set negative: expert 0 receives
    no token (its slots are zero rows: scale-0 rows into quantize_rows)."""
    jcfg = jget_config(arch, precision=prec, reduced=True)
    cfg = get_config(arch, precision=prec, reduced=True)
    p, tree = trees[arch, prec]
    jm = jax.tree.map(lambda a: a[0], p["periods"][0]["moe"])
    jm["router"]["w"] = jm["router"]["w"].at[:, 0].set(-1.0)
    tm = from_reference(tree, cfg, device="cpu").layers[0].moe
    tm.router.weight.data[:, 0] = -1.0
    rng = np.random.default_rng(4)
    x = jnp.asarray(np.abs(rng.standard_normal((3, 8, cfg.d_model))),
                    jnp.bfloat16)
    xt = T(as_np(x)).bfloat16()
    want = as_np(jax.jit(lambda m, x: jmoe.moe(m, x, jcfg, JExecMode(prec)),
                         compiler_options=EXACT)(jm, x))
    got = tmoe.moe(tm, xt, cfg, ExecMode(prec)).float().numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    tol = BF16_TOL if prec == "bf16" else INT_TOL
    assert np.abs(got - want).max() <= tol
    # expert 0 really was empty
    sg = tmoe._group_size(cfg, 24)
    probs = torch.softmax(xt.float().reshape(-1, sg, cfg.d_model)
                          @ tm.router.weight, -1)
    idx, _, _, _ = tmoe._route(probs, cfg.n_experts_per_tok,
                               costmodel.moe_capacity(
                                   sg, cfg.n_experts, cfg.n_experts_per_tok,
                                   cfg.capacity_factor))
    assert not bool((idx == 0).any())


# ---------------------------------------------------------------------------
# the expert-batched GEMM forms' plain versions
# ---------------------------------------------------------------------------

E, M, K, N = 3, 5, 128, 48


def _w8(rng, e=E, k=K, n=N):
    w = torch.from_numpy(rng.integers(-128, 128, (e, k, n))).to(torch.int8)
    return w, torch.from_numpy(rng.uniform(1e-3, 1e-2, (e, n))).float()


def _w4(rng, e=E, k=K, n=N, group=64):
    q = torch.from_numpy(rng.integers(-8, 8, (e, k, n))).to(torch.int8)
    w4 = torch.stack([kq.pack_int4(q[i]) for i in range(e)])
    mul = torch.from_numpy(rng.integers(1, 128, (e, k // group, n))).to(
        torch.int8)
    return w4, mul, torch.from_numpy(rng.uniform(1e-4, 1e-3, (e, n))).float()


def _x(rng):
    x = torch.from_numpy(rng.integers(-128, 128, (E, M, K))).to(torch.int8)
    x[1, 2] = 0                                            # a zero row
    return x, torch.from_numpy(rng.uniform(1e-3, 1e-2, (E, M, 1))).float()


@pytest.mark.parametrize("form", ["int8_gemm", "int4_gemm",
                                  "dual_gemm_gated_i8", "dual_gemm_gated_bf16",
                                  "dual_int4_gemm_gated"])
def test_expert_batched_plain_forms(form, rng):
    x, xs = _x(rng)
    if form == "int8_gemm":
        w, ws = _w8(rng)
        got = ig.int8_gemm_experts(x, w, xs, ws)
        want = [ig.int8_gemm(x[i], w[i], "scaled", x_scale=xs[i],
                             w_scale=ws[i]) for i in range(E)]
    elif form == "int4_gemm":
        w4, mul, ws = _w4(rng)
        got = ig.int4_gemm_experts(x, w4, mul, ws, xs)
        want = [ig.int4_gemm(x[i], w4[i], mul[i], ws[i], xs[i])
                for i in range(E)]
    elif form == "dual_gemm_gated_i8":
        (wu, us), (wg, gs) = _w8(rng), _w8(rng)
        got = ig.dual_gemm_gated_experts(x, wu, wg, xs, us, gs,
                                         act_scale=8 / 127)
        want = [ig.dual_gemm_gated(x[i], wu[i], wg[i], xs[i], us[i], gs[i],
                                   act_scale=8 / 127) for i in range(E)]
    elif form == "dual_gemm_gated_bf16":
        xb = torch.from_numpy(rng.standard_normal((E, M, K))).bfloat16()
        wu = torch.from_numpy(rng.standard_normal((E, K, N)) / 11).bfloat16()
        wg = torch.from_numpy(rng.standard_normal((E, K, N)) / 11).bfloat16()
        got = ig.dual_gemm_gated_experts(xb, wu, wg, act="gelu")
        want = [ig.dual_gemm_gated(xb[i], wu[i], wg[i], act="gelu")
                for i in range(E)]
    else:
        (u4, um, us), (g4, gm, gs) = _w4(rng), _w4(rng)
        got = ig.dual_int4_gemm_gated_experts(x, u4, um, us, g4, gm, gs, xs,
                                              act_scale=8 / 127)
        want = [ig.dual_int4_gemm_gated(x[i], u4[i], um[i], us[i], g4[i],
                                        gm[i], gs[i], xs[i], act_scale=8 / 127)
                for i in range(E)]
    assert got.shape[0] == E
    for i in range(E):
        assert torch.equal(got[i], want[i])


# ---------------------------------------------------------------------------
# PTQ, layer-by-layer init and conversion
# ---------------------------------------------------------------------------

def _state(m):
    return {k: v for k, v in m.state_dict().items()}


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
@pytest.mark.parametrize("arch", ARCHS + ("codeqwen1.5-7b",))
def test_layer_by_layer_init(arch, prec):
    cfg = get_config(arch, precision=prec, reduced=True)
    whole = quantize_for(init_params(cfg, seed=3, device="cpu"), prec)
    by_block = init_params(cfg, seed=3, device="cpu", precision=prec)
    a, b = _state(whole), _state(by_block)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    if cfg.n_experts:
        ex = by_block.layers[0].moe.experts
        assert ex.w_in.quantized and ex.w_in.int4 == (prec == "w4a8")
        assert by_block.layers[0].moe.router.weight is not None


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_bit_exact(trees, arch, prec):
    """PTQ of the converted float model == the reference's PTQ (each
    expert's own channel scales and W4 groups; router and shared gate
    float)."""
    cfg = get_config(arch, precision=prec, reduced=True)
    mine = ptq_quantize_params(
        from_reference(trees[arch, "bf16"][1], cfg, device="cpu"),
        policy=DEFAULT_W4_POLICY if prec == "w4a8" else None)
    assert tree_equal(to_reference(mine, cfg), trees[arch, prec][1])
    moe = mine.layers[0].moe
    assert not moe.router.quantized
    assert moe.shared_gate is None or not moe.shared_gate.quantized


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(trees, arch, prec):
    cfg = get_config(arch, precision=prec, reduced=True)
    tree = trees[arch, prec][1]
    m = from_reference(tree, cfg, device="cpu")
    assert tree_equal(to_reference(m, cfg), tree)
    ex = m.layers[1].moe.experts
    w = ex.w_in.w4 if prec == "w4a8" else (
        ex.w_in.w_q if prec == "w8a8" else ex.w_in.weight)
    assert w.shape[0] == cfg.n_experts
    assert (m.layers[0].moe.shared is not None) == bool(cfg.n_shared_experts)


# ---------------------------------------------------------------------------
# forward and lm_loss against jax.jit
# ---------------------------------------------------------------------------

def _tol(prec):
    return BF16_TOL if prec == "bf16" else W8A8_TOL


def near_ties(run):
    """``run()`` under a recorder of the port's routing: (result, bool
    (B, T) of the tokens whose k-th and (k+1)-th router probabilities lie
    within ``NEAR_TIE`` in some layer)."""
    gaps = []
    route = tmoe._route

    def recording(probs, k, capacity):
        top = torch.sort(probs, dim=-1, descending=True).values
        gaps.append((top[..., k - 1] - top[..., k]).reshape(-1))
        return route(probs, k, capacity)
    tmoe._route = recording
    try:
        out = run()
    finally:
        tmoe._route = route
    return out, torch.stack(gaps).min(0).values < NEAR_TIE


def compared(lj, lt, prec, ties):
    """|lj - lt| over the positions that are not near-ties (all of them at
    the integer precisions, whose routing is bit-exact)."""
    keep = np.ones(lj.shape[:2], bool)
    if prec == "bf16":
        keep = ~ties.reshape(lj.shape[:2]).numpy()
    assert keep.mean() >= MIN_COMPARED
    return np.abs(lj - lt)[keep]


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_no_cache_and_loss(trees, arch, prec):
    jcfg = jget_config(arch, precision=prec, reduced=True)
    cfg = get_config(arch, precision=prec, reduced=True)
    jp, tree = trees[arch, prec]
    tp = from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(2, cfg.vocab_size, (2, 48)).astype(np.int32)
    lj = as_np(jax.jit(lambda p, t: jforward(p, jcfg, t)[0],
                       compiler_options=EXACT)(jp, toks))
    lt, ties = near_ties(lambda: forward(tp, cfg, T(toks).long())[0])
    lt = lt.numpy()
    assert np.isfinite(lt).all() and lt.shape == lj.shape
    assert compared(lj, lt, prec, ties).max() <= _tol(prec)
    if prec == "bf16" and ties.any():
        return                          # the loss averages every position
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want = float(jax.jit(lambda p, t, l: jlm_loss(p, jcfg, t, l),
                         compiler_options=EXACT)(jp, toks, labels))
    got = float(lm_loss(tp, cfg, T(toks).long(), T(labels)))
    assert abs(got - want) <= (1e-5 if prec != "bf16" else 1e-2) * abs(want)


@pytest.mark.parametrize("int8_kv", [True, False])
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_cached(trees, arch, prec, int8_kv):
    """A ragged prefill of 40 tokens (past mixtral-reduced's window of 32,
    into a ring of 32 + 8 slots) and three decode steps, batch 3."""
    jcfg = jget_config(arch, precision=prec, reduced=True)
    cfg = get_config(arch, precision=prec, reduced=True)
    jp, tree = trees[arch, prec]
    tp = from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(2)
    b, t, s = 3, 40, 64
    toks = rng.integers(2, cfg.vocab_size, (b, t)).astype(np.int32)
    lens = np.array([40, 23, 5])
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None],
                   -1).astype(np.int32)
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st),
                compiler_options=EXACT)
    jst = jinit_states(jcfg, b, s, int8_kv=int8_kv, window_slack=8)
    tst = init_states(cfg, b, s, int8_kv=int8_kv, device="cpu",
                      window_slack=8)
    if cfg.sliding_window:
        assert tst[0]["kv"]["k"].shape[1] == 40
    for step in range(4):
        lj, jst = f(jp, toks, pos, jst)
        (lt, tst), ties = near_ties(
            lambda: forward(tp, cfg, T(toks).long(), T(pos), tst))
        lj, lt = np.asarray(lj), lt.numpy()
        assert np.isfinite(lt).all()
        assert compared(lj, lt, prec, ties).max() <= _tol(prec), step
        nxt = lj[np.arange(b), np.maximum(lens - 1, 0)
                 if step == 0 else 0].argmax(-1)
        toks = nxt[:, None].astype(np.int32)
        pos = ((pos.max(1) + 1)[:, None]).astype(np.int32)
        lens = np.ones(b, int)
