"""xlstm-350m's mLSTM and sLSTM blocks in the port against the JAX reference
(``repro.models.ssm``), on the CPU, at ``xlstm-350m-reduced`` (d_model 64,
4 layers: three mLSTM blocks and one sLSTM, 4 heads, LayerNorm, tied
embeddings) with the reference's own weights (``convert.py``) and its own
PTQ.  Inputs come from a numpy seed.

Neither recurrence has a Pallas kernel: the port runs them as torch ops in
f32, whose exp, log1p and cumsum round otherwise than XLA:CPU's, so the
recurrence's f32 output agrees to a few parts in 1e6 and not bit for bit.
The integer projections are bit-exact (``test_projections_bit_exact``); an
f32 difference can still move one int8 activation level of ``wo`` (its
input is quantized per row), so the integer block outputs and logits are
held to a tolerance, not to equality.

Tolerances:
* states (C, n, m; h, c, n, m): ``STATE_TOL``, rtol 1e-5 and atol 1e-6;
  the sLSTM's after 130 steps ``LONG_STATE_TOL`` (rtol 1e-4, atol 1e-5:
  one-ulp differences of exp, tanh and sigmoid compound over the
  recurrence; 4.5e-5 relative measured at seed 2); the model's first
  layer's state at bf16 ``BF16_STATE_TOL`` (rtol 1e-3, atol 1e-4: its bf16
  q/k/v projections round otherwise in XLA:CPU and PyTorch);
* the recurrence's f32 output y (before the inner norm): ``Y_TOL``, rtol
  1e-5 and atol 1e-5 (|y| reaches ~20);
* block outputs: ``BLOCK_TOL`` at bf16 (rtol 2^-7, atol 2e-3; the Mamba-2
  block's bound in ``test_torch_ssm.py``: one bf16 rounding of wo's
  output); ``INT_BLOCK_TOL`` at W8A8/W4A8 (atol 1e-2): one int8 level of
  wo's per-row quantized input moves an output by (row amax / 127) x |w|,
  up to 0.0078 measured;
* logits: ``LOGIT_TOL`` 0.02 at every precision, the model tolerance of
  ``test_torch_models.py`` (measured at seed 0: 0.0092 bf16, 0.014 W8A8,
  0 W4A8 on logits of magnitude ~0.7); greedy tokens equal where the
  reference's top-2 margin is clear;
* ``lm_loss``: ``LOSS_RTOL`` relative;
* PTQ, conversion, the quantized-parameter fraction, served tokens, lane
  resets: exact.

The reference is compiled with ``xla_allow_excess_precision`` off
(``EXACT``), as the zamba2 and MoE tests do: the port keeps every bf16 round
trip the reference's code writes.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.lm import lm_loss as jlm_loss
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.quant.ptq import quantized_param_fraction as jfraction
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import ops
from repro_torch.models import (forward, init_params, init_states, layers,
                                lm_loss, ssm)
from repro_torch.models.blocks import MLSTMBlock, SLSTMBlock
from repro_torch.quant import quantize_for, quantized_param_fraction
from repro_torch.serve import ServeConfig, ServingEngine

XLSTM = "xlstm-350m"
PRECISIONS = ("bf16", "w8a8", "w4a8")
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
LONG_STATE_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STATE_TOL = dict(rtol=1e-3, atol=1e-4)
Y_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=2.0 ** -7, atol=2e-3)
INT_BLOCK_TOL = dict(rtol=2.0 ** -7, atol=1e-2)
LOGIT_TOL = 0.02
LOSS_RTOL = 1e-4
EXACT = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def tree_equal(a, b) -> bool:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(np.asarray(x).dtype == np.asarray(y).dtype
                            and np.array_equal(np.asarray(x), np.asarray(y))
                            for x, y in zip(la, lb))


def _jptq(p, prec):
    if prec == "w8a8":
        return jptq(p)
    if prec == "w4a8":
        return jptq(p, policy=J_W4_POLICY)
    return p


@pytest.fixture(scope="module")
def xlstm():
    """{precision: (reference params, the port's model PTQ'd by the port,
    reference cfg, port cfg)}, seed 0; the port's model is converted from
    the FLOAT reference tree and quantized by the port."""
    out = {}
    p = jinit_params(jax.random.PRNGKey(0),
                     jget_config(XLSTM, reduced=True))
    for prec in PRECISIONS:
        jcfg = jget_config(XLSTM, precision=prec, reduced=True)
        cfg = get_config(XLSTM, precision=prec, reduced=True)
        tp = quantize_for(from_reference(jax.device_get(p), cfg,
                                         device="cpu"), prec)
        out[prec] = (_jptq(p, prec), tp, jcfg, cfg)
    return out


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

KIND_POS = {"mlstm": 0, "slstm": 3}       # the pattern's first of each kind


def _layer(xlstm, prec, kind):
    """(reference leaves of layer 0 of the kind, the port's layer)."""
    p, tp, jcfg, cfg = xlstm[prec]
    pos = KIND_POS[kind]
    jl = jax.tree_util.tree_map(lambda a: a[0], p["periods"][pos][kind])
    return jl, getattr(tp.layers[pos], kind), jcfg, cfg


def _jblock(kind, jcfg, prec, chunk=64):
    fn = {"mlstm": jssm.mlstm, "slstm": jssm.slstm}[kind]
    kw = {"chunk": chunk} if kind == "mlstm" else {}
    mode = jlayers.ExecMode(precision=prec)
    return jax.jit(lambda p, x, st: fn(p, x, jcfg, mode, state=st, **kw),
                   compiler_options=EXACT)


def _tblock(kind, layer, x, cfg, prec, state=None):
    fn = {"mlstm": ssm.mlstm, "slstm": ssm.slstm}[kind]
    return fn(layer, x, cfg, layers.ExecMode(precision=prec), state=state)


def _x(b, t, d, seed=2):
    x = np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), T(x).to(torch.bfloat16)


def _check_state(got: dict, want: dict, tol=STATE_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


def _block_tol(prec):
    return BLOCK_TOL if prec == "bf16" else INT_BLOCK_TOL


@pytest.mark.parametrize("t", [64, 70, 130])
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_no_state(xlstm, kind, prec, t):
    """The chunked mLSTM (t a multiple of 64 or not: pads of 0 and forget
    gates of 30, the final state including them) and the sLSTM loop from
    its init state."""
    jl, layer, jcfg, cfg = _layer(xlstm, prec, kind)
    xj, xt = _x(2, t, cfg.d_model)
    yj, sj = _jblock(kind, jcfg, prec)(jl, xj, None)
    yt, st = _tblock(kind, layer, xt, cfg, prec)
    assert yt.dtype == torch.bfloat16 and yt.shape == tuple(yj.shape)
    np.testing.assert_allclose(as_np(yt), as_np(yj), **_block_tol(prec))
    _check_state(st, sj, LONG_STATE_TOL if kind == "slstm" and t > 70
                 else STATE_TOL)


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_steps_continue_the_recurrence(xlstm, kind, prec):
    """A prefill of 40 tokens, then four t = 1 steps from the prefill's
    final state (the mLSTM's one-step update), each against the reference
    fed the reference's state; the steps also continue the port's own
    prefill as the no-cache block would (the recurrence is one
    function)."""
    jl, layer, jcfg, cfg = _layer(xlstm, prec, kind)
    xj, xt = _x(2, 44, cfg.d_model, seed=4)
    f = _jblock(kind, jcfg, prec)
    yj, sj = f(jl, xj[:, :40], None)
    yt, st = _tblock(kind, layer, xt[:, :40], cfg, prec)
    for i in range(40, 44):
        yj, sj_next = f(jl, xj[:, i:i + 1], sj)
        yt, st = _tblock(kind, layer, xt[:, i:i + 1], cfg, prec,
                         state={k: T(np.asarray(v)) for k, v in sj.items()})
        np.testing.assert_allclose(as_np(yt), as_np(yj), **_block_tol(prec))
        _check_state(st, sj_next)
        sj = sj_next
    # the port's own prefill + steps against its no-cache pass over 44
    whole, _ = _tblock(kind, layer, xt, cfg, "bf16")
    st = None
    for i in range(44):
        y1, st = _tblock(kind, layer, xt[:, i:i + 1], cfg, "bf16", state=st)
    np.testing.assert_allclose(as_np(y1[:, 0]), as_np(whole[:, -1]),
                               **BLOCK_TOL)


def test_mlstm_recurrence_f32(xlstm):
    """``_mlstm_chunked`` on the same f32 inputs as the reference's (three
    chunks of 64): y within ``Y_TOL``, the final state within
    ``STATE_TOL``."""
    rng = np.random.default_rng(5)
    b, t, h, d = 2, 192, 4, 32
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    ig, fg = (rng.normal(size=(b, t, h)).astype(np.float32) * 2
              for _ in range(2))
    yj, sj = jax.jit(lambda *a: jssm._mlstm_chunked(*a, 64))(q, k, v, ig, fg)
    yt, st = ssm._mlstm_chunked(*map(T, (q, k, v, ig, fg)), 64)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **Y_TOL)
    _check_state(dict(zip("Cnm", st)), dict(zip("Cnm", sj)))


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_projections_bit_exact(xlstm, prec):
    """The integer linears that read ``u`` (w_up's bf16 output) take ONE
    quantization of it: q, k, v and the gates equal the reference's (which
    quantizes u for each) bit for bit; w_up itself is a float linear."""
    jl, layer, jcfg, cfg = _layer(xlstm, prec, "mlstm")
    xj, xt = _x(2, 16, cfg.d_model, seed=6)
    jmode, tmode = jlayers.ExecMode(precision=prec), layers.ExecMode(prec)
    names = ("wq", "wk", "wv", "w_if")
    want = jax.jit(lambda p, x: [jlayers.apply_linear(
        jlayers.apply_linear(x, p["w_up"], jmode), p[n], jmode)
        for n in names], compiler_options=EXACT)(jl, xj)
    assert not layer.w_up.quantized
    u = layers.apply_linear(xt, layer.w_up, tmode)
    uq = layers.QRows(*ops.quant_rows(u))
    for n, w in zip(names, want):
        got = layers.apply_linear(u, getattr(layer, n), tmode, xq=uq)
        assert np.array_equal(as_np(got), as_np(w)), n
    # given x's rows (as the block's norm hands them over): one
    # quantization of u, one of wo's input, none of x
    xq = layers.QRows(*ops.quant_rows(xt))
    calls = []
    quant = ops.quant_rows

    def counting(a):
        calls.append(tuple(a.shape))
        return quant(a)
    ops.quant_rows = counting
    try:
        ssm.mlstm(layer, xt, cfg, tmode, xq=xq)
    finally:
        ops.quant_rows = quant
    assert calls == [(2, 16, 2 * cfg.d_model)] * 2, calls


# ---------------------------------------------------------------------------
# the reduced model: conversion, PTQ, forward, lm_loss, states
# ---------------------------------------------------------------------------

def test_config_and_blocks():
    cfg = get_config(XLSTM)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size,
            cfg.tie_embeddings) == (24, 1024, 4, 0, 50304, True)
    assert cfg.block_kinds.count("slstm") == 6 and cfg.has_recurrent_state
    assert ssm._mlstm_dims(cfg) == (2048, 4, 512)
    m = init_params(get_config(XLSTM, reduced=True), seed=0, device="cpu")
    assert [type(b) for b in m.layers] == [MLSTMBlock] * 3 + [SLSTMBlock]
    assert m.unembed is None


@pytest.mark.parametrize("prec", PRECISIONS)
def test_convert_round_trip(xlstm, prec):
    p, _, _, cfg = xlstm[prec]
    tree = jax.device_get(p)
    m = from_reference(tree, cfg, device="cpu")
    assert tree_equal(to_reference(m, cfg), tree)
    assert set(tree["periods"][0]["mlstm"]) == {
        "w_up", "w_gate", "wq", "wk", "wv", "w_if", "norm_scale", "wo"}
    assert set(tree["periods"][3]["slstm"]) == {"w_in", "r_w", "norm_scale",
                                                "wo"}


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_ptq_matches_reference(xlstm, prec):
    """The port's PTQ equals the reference's: wq/wk/wv/wo class ``attn``,
    w_gate/w_if/w_in class ``mlp`` (int4 under the W4 policy), w_up NOT
    quantized (no pattern matches it), r_w and the norm scales float."""
    p, tp, _, cfg = xlstm[prec]
    assert tree_equal(to_reference(tp, cfg), jax.device_get(p))
    ml, sl = tp.layers[0].mlstm, tp.layers[3].slstm
    want4 = prec == "w4a8"
    for lin in (ml.wq, ml.wk, ml.wv, ml.wo, ml.w_gate, ml.w_if, sl.w_in,
                sl.wo):
        assert lin.quantized and lin.int4 == want4
    assert not ml.w_up.quantized and ml.w_up.weight is not None
    assert sl.r_w.dtype == torch.float32 and ml.norm_scale.dtype == torch.float32
    assert quantized_param_fraction(tp) == pytest.approx(jfraction(p),
                                                         rel=1e-12)


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_layer_by_layer_init(prec):
    cfg = get_config(XLSTM, precision=prec, reduced=True)
    whole = quantize_for(init_params(cfg, seed=3, device="cpu"), prec)
    by_block = init_params(cfg, seed=3, device="cpu", precision=prec)
    a, b = whole.state_dict(), by_block.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


def _greedy_agrees(lj, lt):
    err = np.abs(lj - lt).max()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert np.array_equal(lj.argmax(-1)[clear], lt.argmax(-1)[clear])


@pytest.mark.parametrize("prec", PRECISIONS)
def test_no_cache_forward_and_loss(xlstm, prec):
    """T = 70: the mLSTM pads to two chunks.  Logits within ``LOGIT_TOL``,
    greedy tokens equal where the margin is clear, nothing launched; then
    ``lm_loss`` within ``LOSS_RTOL``."""
    p, tp, jcfg, cfg = xlstm[prec]
    tok = _tokens(cfg, 2, 70)
    lj, _ = jax.jit(lambda p, t: jforward(p, jcfg, t),
                    compiler_options=EXACT)(p, tok)
    ops.reset_launch_counts()
    lt, _ = forward(tp, cfg, T(tok).long())
    lj, lt = np.asarray(lj), lt.numpy()
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    assert np.abs(lj - lt).max() <= LOGIT_TOL
    _greedy_agrees(lj, lt)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    want = jax.jit(lambda p, a, b: jlm_loss(p, jcfg, a, b),
                   compiler_options=EXACT)(p, tok[:, :-1], tok[:, 1:])
    got = lm_loss(tp, cfg, T(tok[:, :-1]).long(), T(tok[:, 1:]).long())
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_forward_with_states(xlstm, prec):
    """A prefill of 8 tokens (the chunked mLSTM from a zero state, the sLSTM
    loop) then 4 single-token steps (the one-step updates), each feeding the
    reference's greedy token: logits within ``LOGIT_TOL``; the states of
    the first mLSTM and the sLSTM within ``STATE_TOL`` at W8A8 and W4A8
    (their projections bit-exact), the first mLSTM's within
    ``BF16_STATE_TOL`` at bf16."""
    p, tp, jcfg, cfg = xlstm[prec]
    b = 2
    toks = _tokens(cfg, b, 8, seed=5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (b, 8))
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st),
                compiler_options=EXACT)
    jst = jinit_states(jcfg, b, 32)
    tst = init_states(cfg, b, 32, device="cpu")
    for step in range(5):
        lj, jst = f(p, toks, pos, jst)
        lt, tst = forward(tp, cfg, T(toks).long(), T(pos), tst)
        lj, lt = np.asarray(lj)[:, -1], lt.numpy()[:, -1]
        assert np.abs(lj - lt).max() <= LOGIT_TOL, step
        _greedy_agrees(lj, lt)
        toks = lj.argmax(-1)[:, None].astype(np.int32)
        pos = (pos[:, -1:] + 1).astype(np.int32)
    # at bf16 only the first layer: the others' inputs carry the bf16
    # differences of the layers below (the sLSTM's c 2% apart at seed 5,
    # the logits still within LOGIT_TOL)
    for i in ((0,) if prec == "bf16" else (0, 3)):  # an mLSTM, the sLSTM
        rep, at = divmod(i, cfg.period)
        _check_state(tst[i], {k: np.asarray(v)[rep]
                              for k, v in jst[at].items()},
                     BF16_STATE_TOL if prec == "bf16" else STATE_TOL)


def test_init_states_are_the_references():
    cfg = get_config(XLSTM, reduced=True)
    jst = jinit_states(jget_config(XLSTM, reduced=True), 3, 16)
    tst = init_states(cfg, 3, 16, device="cpu")
    for i, st in enumerate(tst):
        want = {k: np.asarray(v)[i // cfg.period]
                for k, v in jst[i % cfg.period].items()}
        assert set(st) == set(want)
        for k in want:
            assert np.array_equal(st[k].numpy(), want[k]), (i, k)
    # separate tensors: a lane write to one leaf leaves the others alone
    s = tst[3]
    assert len({s[k].data_ptr() for k in s}) == len(s)


# ---------------------------------------------------------------------------
# serving: tokenwise against the reference engine, lanes, lane reset
# ---------------------------------------------------------------------------

SERVE = dict(batch_lanes=3, max_seq=48, int8_kv=True, token_budget=8)


def _serve_prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 11, 3, 8)]


def _drain(eng, prompts, max_new=8):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i)
    return {r["id"]: r["tokens"] for r in eng.run_until_drained()}


@pytest.mark.parametrize("prec,temperature", [("w8a8", 0.0), ("w8a8", 0.7),
                                              ("bf16", 0.0), ("w4a8", 0.7)])
def test_serving_tokenwise_matches_reference(xlstm, prec, temperature):
    """Both engines serve the recurrent arch tokenwise (a token budget is
    asked for); 4 requests on 3 lanes (a lane is reused): the same tokens,
    greedy and sampled, and no kernel launched on the CPU."""
    p, tp, jcfg, cfg = xlstm[prec]
    kw = dict(SERVE, temperature=temperature, seed=2)
    jeng = JServingEngine(p, jcfg, JServeConfig(**kw))
    jeng._step_fn = jax.jit(jeng._step_fn.__wrapped__, static_argnums=(6, 7),
                            compiler_options=EXACT)
    eng = ServingEngine(tp, cfg, ServeConfig(**kw), device="cpu")
    assert eng.mode == jeng.mode == "tokenwise" and not eng.paged
    prompts = _serve_prompts(cfg)
    ops.reset_launch_counts()
    assert _drain(eng, prompts) == _drain(jeng, prompts)
    assert set(eng.stats["forwards"]) == {1}
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_serving_lane_isolation(xlstm):
    """Each request drained alone equals the same request served beside
    the others."""
    _, tp, _, cfg = xlstm["w8a8"]
    prompts = _serve_prompts(cfg)
    together = _drain(ServingEngine(tp, cfg, ServeConfig(**SERVE),
                                    device="cpu"), prompts)
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=8, request_id=i)
        eng.run_until_drained()
    assert {r["id"]: r["tokens"] for r in eng.finished} == together


def test_lane_reset_restores_the_init_state(xlstm):
    """``_reset_lane`` returns every leaf of a lane's mLSTM and sLSTM state to
    a fresh ``init_states``' value — m = -1e30 (mLSTM), n = 1 (sLSTM) — and
    leaves the other lanes alone; a request served on a reused lane gets
    the tokens it gets on a fresh engine."""
    _, tp, _, cfg = xlstm["w8a8"]
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE), device="cpu")
    for i, p in enumerate(_serve_prompts(cfg)[:3]):
        eng.submit(p, max_new=30, request_id=i)
    for _ in range(6):
        eng.step()
    before = [{k: v.clone() for k, v in st.items()} for st in eng.states]
    fresh = init_states(cfg, SERVE["batch_lanes"], SERVE["max_seq"],
                        device="cpu")
    assert all(not torch.equal(st["m"][1], f["m"][1])
               for st, f in zip(eng.states, fresh))
    eng._reset_lane(1)
    for st, old, f in zip(eng.states, before, fresh):
        for k in st:
            assert torch.equal(st[k][1], f[k][1]), k
            assert torch.equal(st[k][0], old[k][0])
            assert torch.equal(st[k][2], old[k][2])
    assert (eng.states[0]["m"][1] == -1e30).all()
    assert (eng.states[3]["n"][1] == 1).all()
    # a lane reused after a finished request: the tokens of a fresh engine
    prompts = _serve_prompts(cfg)
    one_lane = dataclasses.replace(ServeConfig(**SERVE), batch_lanes=1)
    eng = ServingEngine(tp, cfg, one_lane, device="cpu")
    for rid in (0, 1):
        eng.submit(prompts[rid], max_new=8, request_id=rid)
        eng.run_until_drained()
    reused = {r["id"]: r["tokens"] for r in eng.finished}[1]
    fresh_eng = ServingEngine(tp, cfg, one_lane, device="cpu")
    fresh_eng.submit(prompts[1], max_new=8, request_id=1)
    assert reused == fresh_eng.run_until_drained()[0]["tokens"]
