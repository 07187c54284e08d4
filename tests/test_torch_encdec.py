"""whisper-small (encoder-decoder: ``enc`` and ``dec`` blocks) in the port
against the JAX reference, on the CPU, with the reference's own weights
(``convert.py``) and its own PTQ.  Inputs come from a numpy seed.

``reduced()`` gives whisper 4 query heads over 2 KV heads; whisper-small is
multi-head (12 over 12), so the tests run ``dataclasses.replace(
cfg.reduced(), n_kv_heads=4)`` (G = 1, head dim 16, d_model 64, 2 encoder
and 2 decoder layers, 64 frames), built the same way for both packages.

Tolerances:
* ``encode`` at W8A8 and W4A8: exact (the encoder is integer end to end,
  its attention the integer kernel's plain version); at bf16 ``BF16_ENC_TOL``
  (0.02 on outputs of magnitude ~3: XLA:CPU and PyTorch round bf16 matmuls
  and the f32 ``_sdpa`` at other points);
* the decoder's logits: ``LOGIT_TOL`` (0.02, the model tolerance of
  ``test_torch_models.py``) at every precision — cross-attention is f32
  float glue (``_sdpa``, no kernel in the reference), whose rounding can
  move one int8 activation level of the next integer GEMM; greedy tokens
  equal where the reference's top-2 margin is clear of it;
* ``encdec_loss``: ``LOSS_RTOL`` relative;
* the precomputed cross K/V at bf16: ``XKV_BF16_TOL`` (one bf16 rounding
  of the projection);
* incremental decode against the full forward at bf16: ``DECODE_TOL``
  (1e-3, tests/test_models.py's bound; at W8A8 and W4A8 the cache is int8
  and the no-cache attention the integer kernel, two different
  quantizations, so there each step is held to the reference's step);
* conversion, PTQ, the precomputed cross K/V at W8A8 and W4A8, served
  tokens at bf16 and W8A8 (whisper's served precision): exact.

The reference is compiled with ``xla_allow_excess_precision`` off
(``EXACT``), as the other model tests do.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encdec_forward as jencdec_forward
from repro.models import encdec_loss as jencdec_loss
from repro.models import encode as jencode
from repro.models import init_encdec_params as jinit_encdec
from repro.models import init_states as jinit_states
from repro.models import precompute_cross_states as jprecompute
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import ops
from repro_torch.models import (EncDec, encdec_forward, encdec_loss, encode,
                                init_encdec_params, init_states,
                                precompute_cross_states)
from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
from repro_torch.quant.ptq import quantize_for
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "whisper-small"
PRECISIONS = ("bf16", "w8a8", "w4a8")
BF16_ENC_TOL = 0.02
LOGIT_TOL = 0.02
LOSS_RTOL = 1e-4
DECODE_TOL = 1e-3
XKV_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
EXACT = {"xla_allow_excess_precision": False}
B, FRAMES = 2, 64


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


def wcfg(get, prec="bf16"):
    """The reduced whisper config of either package, multi-head (G = 1)."""
    return dataclasses.replace(get(ARCH, precision=prec, reduced=True),
                               n_kv_heads=4)


def _jptq(p, prec):
    if prec == "w8a8":
        return jptq(p)
    if prec == "w4a8":
        return jptq(p, policy=J_W4_POLICY)
    return p


def _frames(seed=1, b=B):
    return (np.random.default_rng(seed).normal(size=(b, FRAMES, 64))
            * 0.02).astype(np.float32)


def _tokens(seed=2, b=B, t=16):
    return np.random.default_rng(seed).integers(2, 256, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def trees():
    """{precision: (jax params, numpy tree)}, seed 0, the integer ones
    PTQ'd by the reference."""
    jf = jinit_encdec(jax.random.PRNGKey(0), wcfg(jget_config))
    return {prec: (p, jax.device_get(p))
            for prec in PRECISIONS for p in [_jptq(jf, prec)]}


def _models(trees, prec):
    """(jax cfg, jax params, port cfg, port EncDec) at ``prec``."""
    jp, tree = trees[prec]
    cfg = wcfg(get_config, prec)
    return wcfg(jget_config, prec), jp, cfg, from_reference(tree, cfg,
                                                            device="cpu")


def _jit(fn):
    return jax.jit(fn, compiler_options=EXACT)


# ---------------------------------------------------------------------------
# registration, the launcher, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_the_references(reduced):
    assert ARCH in ARCH_IDS
    cfg = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config(ARCH, reduced=reduced))
    if not reduced:
        assert (cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
                cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                cfg.n_audio_frames) == (12, 12, 768, 12, 12, 64, 3072,
                                        51865, 1500)
        assert cfg.block_pattern == ("dec",) and cfg.activation == "gelu"
        assert cfg.norm_type == "layernorm" and cfg.tie_embeddings


def test_launcher_cpu(capsys):
    """As in the reference, the launcher serves the decoder alone, its
    cross-attention reading the zero cross K/V of ``init_states`` (C17)."""
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--w8a8", "--int8-kv", "--requests",
          "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "mode=packed" in out


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = wcfg(get_config, "w8a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_encdec_params(cfg, precision="w8a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 16)
    p = init_encdec_params(cfg, device="cpu", precision="w8a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(p.decoder, cfg, ServeConfig(max_seq=16, token_budget=4))


# ---------------------------------------------------------------------------
# conversion, PTQ, layer-by-layer init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
def test_convert_round_trip(trees, prec):
    *_, cfg, m = _models(trees, prec)
    assert isinstance(m, EncDec)
    assert tree_equal(to_reference(m, cfg), trees[prec][1])


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_ptq_bit_exact(trees, prec):
    """The encoder's and the decoder's self- and cross-attention and MLP
    linears quantized as the reference quantizes them; ``pos_embed``, the
    norms and the tied embedding stay float."""
    cfg = wcfg(get_config, prec)
    mine = ptq_quantize_params(
        from_reference(trees["bf16"][1], cfg, device="cpu"),
        policy=DEFAULT_W4_POLICY if prec == "w4a8" else None)
    assert tree_equal(to_reference(mine, cfg), trees[prec][1])
    dec = mine.decoder.layers[0]
    assert dec.xattn.wk.int4 == (prec == "w4a8")
    assert mine.encoder.layers[0].mlp.w_in.quantized
    assert mine.encoder.pos_embed.dtype == torch.float32


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_layer_by_layer_init(prec):
    cfg = wcfg(get_config, prec)
    whole = quantize_for(init_encdec_params(cfg, seed=2, device="cpu"), prec)
    by_block = init_encdec_params(cfg, seed=2, device="cpu", precision=prec)
    a, b = whole.state_dict(), by_block.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
def test_encode(trees, prec):
    """Bit-equal at W8A8 and W4A8; the output is f32 (the f32 pos_embed
    promotes the stream, as in the reference)."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    fr = _frames()
    want = np.asarray(_jit(lambda p, f: jencode(p, jcfg, f))(jp, fr))
    ops.reset_launch_counts()
    got = encode(tp, cfg, T(fr))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if prec == "bf16":
        assert np.abs(got.numpy() - want).max() <= BF16_ENC_TOL
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_encoder_is_causal_as_the_references(trees, prec):
    """ROADMAP C16: the reference's ``encode`` asks for ``causal=False`` but
    ``block_forward`` never hands it on, so its encoder attends causally.
    Changing frames t + 1.. leaves rows 0..t of the output unchanged, in
    both packages, and changes row t + 1."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    fr = _frames()
    t = 23
    fr2 = fr.copy()
    fr2[:, t + 1:] = _frames(seed=9)[:, t + 1:]
    jenc = _jit(lambda p, f: jencode(p, jcfg, f))
    for enc in (lambda f: np.asarray(jenc(jp, f)),
                lambda f: encode(tp, cfg, T(f)).numpy()):
        a, b = enc(fr), enc(fr2)
        assert np.array_equal(a[:, :t + 1], b[:, :t + 1])
        assert not np.array_equal(a[:, t + 1], b[:, t + 1])


# ---------------------------------------------------------------------------
# forward, loss, cross states, incremental decode
# ---------------------------------------------------------------------------

def _clear(lj, tol=LOGIT_TOL):
    top = np.sort(lj, -1)[..., -2:]
    return (top[..., 1] - top[..., 0]) > 2 * tol


@pytest.mark.parametrize("prec", PRECISIONS)
def test_encdec_forward_and_loss(trees, prec):
    jcfg, jp, cfg, tp = _models(trees, prec)
    fr, toks = _frames(), _tokens()
    lj, _, ej = _jit(lambda p, f, t: jencdec_forward(p, jcfg, f, t))(
        jp, fr, toks)
    lt, st, et = encdec_forward(tp, cfg, T(fr), T(toks).long())
    lj, lt = np.asarray(lj), lt.numpy()
    assert st is None and np.isfinite(lt).all() and lt.shape == lj.shape
    assert np.abs(lj - lt).max() <= LOGIT_TOL
    clear = _clear(lj)
    assert np.array_equal(lj.argmax(-1)[clear], lt.argmax(-1)[clear])
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want = float(_jit(lambda p, f, t, l: jencdec_loss(p, jcfg, f, t, l))(
        jp, fr, toks, labels))
    got = float(encdec_loss(tp, cfg, T(fr), T(toks).long(), T(labels)))
    assert abs(got - want) <= LOSS_RTOL * want


@pytest.mark.parametrize("prec", PRECISIONS)
def test_precompute_cross_states(trees, prec):
    """Each ``dec`` layer's xk/xv from the reference's encoder output, in
    the state's dtype: equal to the reference's at W8A8 and W4A8 (the same
    integer GEMMs on the same rows), within one bf16 rounding
    (``XKV_BF16_TOL``) at bf16; the self-attention cache is left as it
    was."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    ej = _jit(lambda p, f: jencode(p, jcfg, f))(jp, _frames())
    jst = _jit(lambda p, e, s: jprecompute(p["decoder"], jcfg, e, s))(
        jp, ej, jinit_states(jcfg, B, 32, int8_kv=True))
    tst = init_states(cfg, B, 32, int8_kv=True, device="cpu")
    new = precompute_cross_states(tp.decoder, cfg, T(ej), tst)
    for i, st in enumerate(new):
        assert st["kv"] is tst[i]["kv"]
        for k in ("xk", "xv"):
            want = as_np(jst[0][k][i])
            assert st[k].dtype == torch.bfloat16
            if prec == "bf16":
                np.testing.assert_allclose(as_np(st[k]), want,
                                           **XKV_BF16_TOL)
            else:
                assert np.array_equal(as_np(st[k]), want), (i, k)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_incremental_decode(trees, prec):
    """``encdec_forward`` with states (a prefill of 8 that fills the cross
    states, then 4 single-token steps reusing ``enc_out``) equals the
    reference's same steps within ``LOGIT_TOL``, and at bf16 the full
    forward within ``DECODE_TOL`` (tests/test_models.py's check; a bf16
    cache there)."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    fr, toks = _frames(), _tokens(t=12)
    full, _, _ = encdec_forward(tp, cfg, T(fr), T(toks).long())
    jstep = _jit(lambda p, f, t, ps, s, e: jencdec_forward(
        p, jcfg, f, t, states=s, positions=ps, enc_out=e)[:2])
    jpre = _jit(lambda p, f, t, ps, s: jencdec_forward(
        p, jcfg, f, t, states=s, positions=ps))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (B, 8))
    int8_kv = prec != "bf16"
    jst = jinit_states(jcfg, B, 16, int8_kv=int8_kv)
    tst = init_states(cfg, B, 16, int8_kv=int8_kv, device="cpu")
    lj, jst, ej = jpre(jp, fr, toks[:, :8], pos, jst)
    lt, tst, et = encdec_forward(tp, cfg, T(fr), T(toks[:, :8]).long(),
                                 states=tst, positions=T(pos))
    errs = [float((full[:, :8] - lt).abs().max())]
    assert np.abs(np.asarray(lj) - lt.numpy()).max() <= LOGIT_TOL
    for i in range(8, 12):
        p1 = np.full((B, 1), i, np.int32)
        lj, jst = jstep(jp, fr, toks[:, i:i + 1], p1, jst, ej)
        lt, tst, _ = encdec_forward(tp, cfg, None, T(toks[:, i:i + 1]).long(),
                                    states=tst, positions=T(p1), enc_out=et)
        errs.append(float((full[:, i:i + 1] - lt).abs().max()))
        assert np.abs(np.asarray(lj) - lt.numpy()).max() <= LOGIT_TOL, i
    if prec == "bf16":
        assert max(errs) <= DECODE_TOL, errs


# ---------------------------------------------------------------------------
# serving with kv_source = encode(clips)
# ---------------------------------------------------------------------------

SERVE = dict(batch_lanes=3, max_seq=48, int8_kv=True, token_budget=8)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(2, 256, n).tolist() for n in (9, 3, 17, 5)]


def _drain(eng, prompts, max_new=6):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i)
    return {r["id"]: r["tokens"] for r in eng.run_until_drained()}


def _engines(trees, prec, lanes=3, **kw):
    """The reference's and the port's engines over the decoder, with each
    lane's ``kv_source`` the encoding of its stub clip."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    fr = _frames(seed=4, b=lanes)
    scfg = dict(SERVE, batch_lanes=lanes, **kw)
    ej = _jit(lambda p, f: jencode(p, jcfg, f))(jp, fr)
    jeng = JServingEngine(jp["decoder"], jcfg, JServeConfig(**scfg),
                          kv_source=ej)
    jeng._step_fn = jax.jit(jeng._step_fn.__wrapped__, static_argnums=(6, 7),
                            compiler_options=EXACT)
    eng = ServingEngine(tp.decoder, cfg, ServeConfig(**scfg), device="cpu",
                        kv_source=encode(tp, cfg, T(fr)))
    return jeng, eng


@pytest.mark.parametrize("prec", ("bf16", "w8a8"))
def test_serving_matches_the_reference(trees, prec):
    """Greedy tokens of the packed engine (3 lanes, 4 requests: a lane is
    reused) equal ``repro.serve.ServingEngine``'s with ``kv_source``; no
    kernel is launched on the CPU."""
    jeng, eng = _engines(trees, prec)
    assert eng.mode == jeng.mode == "packed"
    ops.reset_launch_counts()
    got, want = _drain(eng, _prompts()), _drain(jeng, _prompts())
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert got == want


def test_reused_lane_equals_a_fresh_engine(trees):
    """On one lane, a request served after another gets the tokens a fresh
    engine gives it: the reset leaves the lane's cross K/V as init wrote
    them and clears its self-attention cache."""
    _, eng = _engines(trees, "w8a8", lanes=1)
    prompts = _prompts()
    first = {k: eng.states[0][k].clone() for k in ("xk", "xv")}
    for rid in (0, 1):
        eng.submit(prompts[rid], max_new=6, request_id=rid)
        eng.run_until_drained()
    reused = {r["id"]: r["tokens"] for r in eng.finished}[1]
    assert all(torch.equal(eng.states[0][k], v) for k, v in first.items())
    _, fresh = _engines(trees, "w8a8", lanes=1)
    fresh.submit(prompts[1], max_new=6, request_id=1)
    assert reused == fresh.run_until_drained()[0]["tokens"]


def test_paged_falls_back_to_dense(trees):
    _, dense = _engines(trees, "w8a8")
    _, eng = _engines(trees, "w8a8", paged=True, page_size=4)
    assert not eng.paged and eng.pool is None
    assert _drain(eng, _prompts()) == _drain(dense, _prompts())
