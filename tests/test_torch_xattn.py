"""llama-3.2-vision-90b (the ``xattn`` cross-attention block every fifth
layer) in the port against the JAX reference, on the CPU, with the
reference's own weights (``convert.py``) and its own PTQ.  Inputs and the
stub vision tokens come from a numpy seed.

``reduced()`` gives the model 4 query heads over 2 KV heads (G = 2); the
model tests run a G-PRESERVING reduced config instead, built the same way
for both packages: ``dataclasses.replace(cfg.reduced(), n_heads=16,
n_kv_heads=2)`` at head dim 16 — G = 8, vision-90b's 64 over 8; 5 layers
(4 ``attn`` and 1 ``xattn``), 16 vision tokens.  The cross layer's gates
are zero at init, which makes the block the identity, so the reference's
tree gets ``gate_attn`` 0.5 and ``gate_mlp`` -0.7 before the port converts
it.

Tolerances:
* logits with ``kv_source``: ``LOGIT_TOL`` (0.02, the model tolerance of
  ``test_torch_models.py``) at every precision — cross-attention is f32
  float glue (``_sdpa``, no kernel in the reference), whose rounding can
  move one int8 activation level of the next integer GEMM; greedy tokens
  equal where the reference's top-2 margin is clear of it; without
  ``kv_source`` (the cross layer becomes causal self-attention) exact at
  W8A8 and W4A8;
* ``lm_loss``: ``LOSS_RTOL`` relative;
* the precomputed cross K/V: exact at W8A8 and W4A8, ``XKV_BF16_TOL`` at
  bf16 (one bf16 rounding of the projection);
* incremental decode against the full forward at bf16: ``DECODE_TOL``
  (tests/test_models.py's 1e-3); every step against the reference's within
  ``LOGIT_TOL``;
* conversion, PTQ (C14 on a widened d_ff too), served tokens: exact;
* the dense decode attention's plain version at G = 8 against
  ``repro.kernels.ref``: the kernel module's ``RTOL``/``ATOL``.

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
from repro.kernels import ref
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.models import lm_loss as jlm_loss
from repro.models import precompute_cross_states as jprecompute
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import ops
from repro_torch.kernels.int8_kv_decode_attention import (
    ATOL, RTOL, int8_kv_decode_attention_ref)
from repro_torch.models import (forward, init_params, init_states, lm_loss,
                                precompute_cross_states)
from repro_torch.models.blocks import XAttnBlock, block_forward
from repro_torch.models.lm import exec_mode
from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
from repro_torch.quant.ptq import quantize_for
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "llama-3.2-vision-90b"
PRECISIONS = ("bf16", "w8a8", "w4a8")
LOGIT_TOL = 0.02
LOSS_RTOL = 1e-4
DECODE_TOL = 1e-3
XKV_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
GATES = (0.5, -0.7)
EXACT = {"xla_allow_excess_precision": False}
B, SV = 2, 16


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


def vcfg(get, prec="bf16", **kw):
    """The G-preserving reduced config of either package (G = 8)."""
    return dataclasses.replace(get(ARCH, precision=prec, reduced=True),
                               n_heads=16, n_kv_heads=2, **kw)


def _jptq(p, prec):
    if prec == "w8a8":
        return jptq(p)
    if prec == "w4a8":
        return jptq(p, policy=J_W4_POLICY)
    return p


def _gated(p):
    """The reference's float tree with the cross layer's gates nonzero."""
    per = list(p["periods"])
    per[4] = dict(per[4], gate_attn=jnp.full((1, 1), GATES[0], jnp.float32),
                  gate_mlp=jnp.full((1, 1), GATES[1], jnp.float32))
    return dict(p, periods=per)


def _src(seed=1, b=B):
    return (np.random.default_rng(seed).normal(size=(b, SV, 64))
            * 0.02).astype(np.float32)


def _tokens(seed=2, b=B, t=16):
    return np.random.default_rng(seed).integers(2, 256, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def trees():
    """{precision: (jax params, numpy tree)}, seed 0, gates nonzero, the
    integer ones PTQ'd by the reference."""
    jf = _gated(jinit_params(jax.random.PRNGKey(0), vcfg(jget_config)))
    return {prec: (p, jax.device_get(p))
            for prec in PRECISIONS for p in [_jptq(jf, prec)]}


def _models(trees, prec):
    jp, tree = trees[prec]
    cfg = vcfg(get_config, prec)
    return vcfg(jget_config, prec), jp, cfg, from_reference(tree, cfg,
                                                            device="cpu")


def _jit(fn):
    return jax.jit(fn, compiler_options=EXACT)


def _clear(lj, tol=LOGIT_TOL):
    top = np.sort(lj, -1)[..., -2:]
    return (top[..., 1] - top[..., 0]) > 2 * tol


# ---------------------------------------------------------------------------
# registration, the launcher, entry points, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_the_references(reduced):
    assert ARCH in ARCH_IDS
    cfg = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config(ARCH, reduced=reduced))
    if not reduced:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                cfg.n_vision_tokens) == (100, 8192, 64, 8, 128, 28672,
                                         128256, 1601)
        assert cfg.block_pattern == ("attn",) * 4 + ("xattn",)
        assert cfg.activation == "silu" and cfg.norm_type == "rmsnorm"


@pytest.mark.parametrize("flags", [["--w4a8"], ["--w8a8", "--paged"]])
def test_launcher_cpu(capsys, flags):
    """The launcher feeds stub vision tokens; ``--paged`` falls back to the
    dense layout (no pool line)."""
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--int8-kv", "--requests", "2",
          "--max-new", "3", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "paged pool" not in out


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = vcfg(get_config, "w4a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, precision="w4a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 16)
    p = init_params(cfg, device="cpu", precision="w4a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(p, cfg, ServeConfig(max_seq=16, token_budget=4))


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_layer_by_layer_init(prec):
    cfg = vcfg(get_config, prec)
    whole = quantize_for(init_params(cfg, seed=2, device="cpu"), prec)
    by_block = init_params(cfg, seed=2, device="cpu", precision=prec)
    a, b = whole.state_dict(), by_block.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


def test_zero_gates_make_the_block_the_identity():
    """At init (gates 0) the ``xattn`` block returns its input, whatever
    the features: tanh(0) = 0."""
    cfg = vcfg(get_config, "w8a8")
    p = init_params(cfg, seed=3, device="cpu", precision="w8a8")
    blk = p.layers[4]
    assert isinstance(blk, XAttnBlock) and not blk.gate_attn.any()
    x = torch.randn(B, 8, 64, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32).expand(B, 8)
    y, _ = block_forward("xattn", blk, x, cfg, exec_mode(cfg), pos,
                         kv_source=T(_src()))
    assert torch.equal(y, x)


# ---------------------------------------------------------------------------
# conversion and PTQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
def test_convert_round_trip(trees, prec):
    *_, cfg, m = _models(trees, prec)
    assert tree_equal(to_reference(m, cfg), trees[prec][1])
    blk = m.layers[4]
    assert isinstance(blk, XAttnBlock)
    assert blk.gate_attn.tolist() == [GATES[0]]
    assert blk.gate_mlp.tolist() == [np.float32(GATES[1]).item()]


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_ptq_bit_exact(trees, prec):
    """Cross-attention's q/k/v/o quantized as the reference does; the gates
    and norms stay float."""
    cfg = vcfg(get_config, prec)
    mine = ptq_quantize_params(
        from_reference(trees["bf16"][1], cfg, device="cpu"),
        policy=DEFAULT_W4_POLICY if prec == "w4a8" else None)
    assert tree_equal(to_reference(mine, cfg), trees[prec][1])
    blk = mine.layers[4]
    assert blk.xattn.wk.int4 == (prec == "w4a8")
    assert blk.gate_attn.dtype == torch.float32


def test_w4_policy_keeps_a_wide_down_projection_int8():
    """ROADMAP C14 at vision-90b's d_ff (K = 28672 > 16513): on a widened
    reduced config (d_ff 16640) the port's W4A8 tree equals the
    reference's except the down projections, which equal the reference's
    int8 ones; up and gate stay int4."""
    jf = _gated(jinit_params(jax.random.PRNGKey(1),
                             vcfg(jget_config, d_ff=16640)))
    cfg = vcfg(get_config, "w4a8", d_ff=16640)
    mine = ptq_quantize_params(
        from_reference(jax.device_get(jf), cfg, device="cpu"),
        policy=DEFAULT_W4_POLICY)
    want = jax.device_get(jptq(jf, policy=J_W4_POLICY))
    int8 = jax.device_get(jptq(jf))
    for per, per8 in zip(want["periods"], int8["periods"]):
        per["mlp"]["w_out"] = per8["mlp"]["w_out"]
    assert tree_equal(to_reference(mine, cfg), want)
    assert all(not b.mlp.w_out.int4 and b.mlp.w_in.int4 for b in mine.layers)
    assert get_config(ARCH).d_ff > 16513


# ---------------------------------------------------------------------------
# forward, loss, cross states, incremental decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
def test_forward_and_loss_with_kv_source(trees, prec):
    jcfg, jp, cfg, tp = _models(trees, prec)
    src, toks = _src(), _tokens()
    lj = as_np(_jit(lambda p, t, s: jforward(p, jcfg, t, kv_source=s)[0])(
        jp, toks, src))
    ops.reset_launch_counts()
    lt = forward(tp, cfg, T(toks).long(), kv_source=T(src))[0].numpy()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert np.isfinite(lt).all() and lt.shape == lj.shape
    assert np.abs(lj - lt).max() <= LOGIT_TOL
    clear = _clear(lj)
    assert np.array_equal(lj.argmax(-1)[clear], lt.argmax(-1)[clear])
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want = float(_jit(lambda p, t, l, s: jlm_loss(p, jcfg, t, l,
                                                  kv_source=s))(
        jp, toks, labels, src))
    got = float(lm_loss(tp, cfg, T(toks).long(), T(labels),
                        kv_source=T(src)))
    assert abs(got - want) <= LOSS_RTOL * want


@pytest.mark.parametrize("prec", PRECISIONS)
def test_forward_without_kv_source(trees, prec):
    """Without features or states the reference's cross layer is causal
    self-attention with RoPE on its own weights; the port mirrors it
    (exact at W8A8 and W4A8: every op of that path is an integer kernel's
    plain version)."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    toks = _tokens(seed=5)
    lj = as_np(_jit(lambda p, t: jforward(p, jcfg, t)[0])(jp, toks))
    lt = forward(tp, cfg, T(toks).long())[0].numpy()
    assert np.abs(lj - lt).max() <= (LOGIT_TOL if prec == "bf16" else 0.0)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_precompute_cross_states(trees, prec):
    jcfg, jp, cfg, tp = _models(trees, prec)
    src = _src()
    jst = _jit(lambda p, s, st: jprecompute(p, jcfg, s, st))(
        jp, src, jinit_states(jcfg, B, 32, int8_kv=True))
    tst = init_states(cfg, B, 32, int8_kv=True, device="cpu")
    new = precompute_cross_states(tp, cfg, T(src), tst)
    for i, (st, old) in enumerate(zip(new, tst)):
        if i != 4:
            assert st is old
            continue
        assert set(st) == {"xk", "xv"}
        for k in ("xk", "xv"):
            want = as_np(jst[4][k][0])
            assert st[k].shape == (B, SV, 2, 16)
            if prec == "bf16":
                np.testing.assert_allclose(as_np(st[k]), want,
                                           **XKV_BF16_TOL)
            else:
                assert np.array_equal(as_np(st[k]), want), k


@pytest.mark.parametrize("prec", PRECISIONS)
def test_incremental_decode(trees, prec):
    """A prefill of 8 tokens over states whose cross K/V were precomputed,
    then 4 single-token steps: each within ``LOGIT_TOL`` of the reference's
    same step, and at bf16 within ``DECODE_TOL`` of the full forward."""
    jcfg, jp, cfg, tp = _models(trees, prec)
    src, toks = _src(), _tokens(t=12)
    full = forward(tp, cfg, T(toks).long(), kv_source=T(src))[0]
    f = _jit(lambda p, t, ps, st: jforward(p, jcfg, t, positions=ps,
                                           states=st))
    int8_kv = prec != "bf16"
    jst = _jit(lambda p, s, st: jprecompute(p, jcfg, s, st))(
        jp, src, jinit_states(jcfg, B, 16, int8_kv=int8_kv))
    tst = precompute_cross_states(tp, cfg, T(src), init_states(
        cfg, B, 16, int8_kv=int8_kv, device="cpu"))
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (B, 8))
    lj, jst = f(jp, toks[:, :8], pos, jst)
    lt, tst = forward(tp, cfg, T(toks[:, :8]).long(), T(pos), tst)
    errs = [float((full[:, :8] - lt).abs().max())]
    assert np.abs(np.asarray(lj) - lt.numpy()).max() <= LOGIT_TOL
    for i in range(8, 12):
        p1 = np.full((B, 1), i, np.int32)
        lj, jst = f(jp, toks[:, i:i + 1], p1, jst)
        lt, tst = forward(tp, cfg, T(toks[:, i:i + 1]).long(), T(p1), tst)
        errs.append(float((full[:, i:i + 1] - lt).abs().max()))
        assert np.abs(np.asarray(lj) - lt.numpy()).max() <= LOGIT_TOL, i
    if prec == "bf16":
        assert max(errs) <= DECODE_TOL, errs


# ---------------------------------------------------------------------------
# serving with kv_source
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
    jcfg, jp, cfg, tp = _models(trees, prec)
    src = _src(seed=4, b=lanes)
    scfg = dict(SERVE, batch_lanes=lanes, **kw)
    jeng = JServingEngine(jp, jcfg, JServeConfig(**scfg), kv_source=src)
    jeng._step_fn = jax.jit(jeng._step_fn.__wrapped__, static_argnums=(6, 7),
                            compiler_options=EXACT)
    eng = ServingEngine(tp, cfg, ServeConfig(**scfg), device="cpu",
                        kv_source=T(src))
    return jeng, eng


@pytest.mark.parametrize("prec", ("bf16", "w4a8"))
def test_serving_matches_the_reference(trees, prec):
    """Greedy tokens of the packed engine (3 lanes, 4 requests: a lane is
    reused) equal ``repro.serve.ServingEngine``'s with ``kv_source``."""
    jeng, eng = _engines(trees, prec)
    assert eng.mode == jeng.mode == "packed"
    ops.reset_launch_counts()
    got, want = _drain(eng, _prompts()), _drain(jeng, _prompts())
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert got == want


def test_reused_lane_equals_a_fresh_engine(trees):
    _, eng = _engines(trees, "w4a8", lanes=1)
    prompts = _prompts()
    first = {k: eng.states[4][k].clone() for k in ("xk", "xv")}
    for rid in (2, 1):
        eng.submit(prompts[rid], max_new=6, request_id=rid)
        eng.run_until_drained()
    reused = {r["id"]: r["tokens"] for r in eng.finished}[1]
    assert all(torch.equal(eng.states[4][k], v) for k, v in first.items())
    _, fresh = _engines(trees, "w4a8", lanes=1)
    fresh.submit(prompts[1], max_new=6, request_id=1)
    assert reused == fresh.run_until_drained()[0]["tokens"]


def test_paged_falls_back_to_dense(trees):
    _, dense = _engines(trees, "w4a8")
    _, eng = _engines(trees, "w4a8", paged=True, page_size=4)
    assert not eng.paged and eng.pool is None
    assert _drain(eng, _prompts()) == _drain(dense, _prompts())


# ---------------------------------------------------------------------------
# the dense decode attention's plain version at G = 8
# ---------------------------------------------------------------------------

def _int8(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    s = (np.abs(x).max(-1, keepdims=True) / 127.0).astype(np.float32)
    return np.clip(np.round(x / s), -128, 127).astype(np.int8), s


@pytest.mark.parametrize("d", [16, 128])
def test_dense_decode_plain_at_g8(rng, d):
    """8 lanes of 40 slots over 2 KV heads (lane 1 idle), 16 query heads."""
    b, s, hkv, g = 8, 40, 2, 8
    k_q, k_s = _int8(rng, (b, s, hkv, d))
    v_q, v_s = _int8(rng, (b, s, hkv, d))
    fill = rng.integers(1, s + 1, b)
    fill[1] = 0
    slot = np.arange(s)
    pos = np.where(slot[None] < fill[:, None], slot[None], -1).astype(np.int32)
    qpos = (fill - 1).astype(np.int32)
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    args = (q, k_q, k_s, v_q, v_s, pos, qpos)
    want = jax.jit(ref.int8_kv_decode_attention_ref)(*args)
    got = int8_kv_decode_attention_ref(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
