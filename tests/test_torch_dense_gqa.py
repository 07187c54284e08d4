"""internlm2-20b and yi-34b (dense GQA, SwiGLU, RMSNorm, no qkv bias) in the
port against the JAX reference, on the CPU, with the reference's own
weights (``convert.py``) and its own PTQ.  Inputs come from a numpy seed.

``reduced()`` gives both models 4 query heads over 2 KV heads (G = 2), so
the model tests run a G-PRESERVING reduced config instead, built the same
way for both packages: ``dataclasses.replace(cfg.reduced(), n_heads=12 or
14, n_kv_heads=2)`` at head dim 16 — G = 6 (internlm2-20b: 48 over 8) and
G = 7 (yi-34b: 56 over 8, the first odd G above 1).

Tolerances:
* the no-cache forward's logits at W8A8 and W4A8: ``INT_TOL`` = 0 (every
  integer kernel's plain version is bit-exact, and the no-cache integer
  attention is integer); at bf16 ``BF16_TOL`` (0.02, the model tolerance
  of ``test_torch_models.py``: XLA:CPU and PyTorch round bf16 matmuls at
  other points);
* ``lm_loss``: ``LOSS_RTOL`` relative at the integer precisions, 1e-2 at
  bf16;
* the cached forward: ``W8A8_TOL`` (0.02) at every precision — the cache
  attention is float glue (``_sdpa``) whose bf16 rounding can move one int8
  activation level of the next integer GEMM;
* PTQ, the converted trees, the served tokens, paged against dense: exact;
* the decode attentions' plain versions at G = 6 and 7 against
  ``repro.kernels.ref``: the ``RTOL``/``ATOL`` of the port's kernel
  modules.

The reference is compiled with ``xla_allow_excess_precision`` off
(``EXACT``), as the other model tests do: the port keeps every bf16 round
trip the reference's code writes.
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
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import ops
from repro_torch.kernels.int8_kv_decode_attention import (
    ATOL, RTOL, int8_kv_decode_attention_ref)
from repro_torch.kernels.paged_attention import paged_decode_attention_ref
from repro_torch.models import forward, init_params, init_states, lm_loss
from repro_torch.models.layers import ExecMode, Linear, apply_linear
from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
from repro_torch.quant.ptq import quantize_for
from repro_torch.serve import ServeConfig, ServingEngine

# arch -> query heads of the G-preserving reduced config (2 KV heads)
GQA = {"internlm2-20b": 12, "yi-34b": 14}
# the full configs' (layers, d_model, heads, kv heads, d_ff, vocab, theta)
FULL = {"internlm2-20b": (48, 6144, 48, 8, 16384, 92544, 1e6),
        "yi-34b": (60, 7168, 56, 8, 20480, 64000, 5e6)}
PRECISIONS = ("bf16", "w8a8", "w4a8")
INT_TOL = 0.0
W8A8_TOL = 0.02
BF16_TOL = 0.02
LOSS_RTOL = 1e-5
EXACT = {"xla_allow_excess_precision": False}


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


def gqa_config(get, arch: str, prec: str = "bf16"):
    """The G-preserving reduced config of either package."""
    return dataclasses.replace(get(arch, precision=prec, reduced=True),
                               n_heads=GQA[arch], n_kv_heads=2)


def _jptq(p, prec):
    if prec == "w8a8":
        return jptq(p)
    if prec == "w4a8":
        return jptq(p, policy=J_W4_POLICY)
    return p


@pytest.fixture(scope="module")
def trees():
    """{(arch, precision): (jax params, numpy tree)} of the G-preserving
    reduced models, seed 0; the integer ones PTQ'd by the reference."""
    out = {}
    for arch in GQA:
        jf = jinit_params(jax.random.PRNGKey(0), gqa_config(jget_config, arch))
        for prec in PRECISIONS:
            p = _jptq(jf, prec)
            out[arch, prec] = (p, jax.device_get(p))
    return out


def _models(trees, arch, prec):
    """(jax cfg, jax params, port cfg, port model) at ``prec``."""
    jp, tree = trees[arch, prec]
    cfg = gqa_config(get_config, arch, prec)
    return (gqa_config(jget_config, arch, prec), jp, cfg,
            from_reference(tree, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# registration (the three archs of this slice) and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["internlm2-20b", "yi-34b", "xlstm-350m"])
def test_config_fields_equal_the_references(arch, reduced):
    assert arch in ARCH_IDS
    assert (dataclasses.asdict(get_config(arch, reduced=reduced))
            == dataclasses.asdict(jget_config(arch, reduced=reduced)))


@pytest.mark.parametrize("arch", ["internlm2-20b", "yi-34b", "xlstm-350m"])
def test_entry_points_default_to_the_card(arch, monkeypatch):
    """Without a card the new archs' entry points raise rather than fall
    back; with ``device="cpu"`` they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(arch, precision="w8a8", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, precision="w8a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 16)
    params = init_params(cfg, device="cpu", precision="w8a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, ServeConfig(max_seq=16, token_budget=4))


@pytest.mark.parametrize("arch", list(GQA))
def test_full_configs_are_gqa_at_g_6_and_7(arch):
    cfg = get_config(arch)
    layers, d, h, hkv, ff, vocab, theta = FULL[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.rope_theta) == FULL[arch]
    assert cfg.head_dim == 128 and not cfg.qkv_bias
    assert cfg.block_pattern == ("attn",) and cfg.norm_type == "rmsnorm"
    red = gqa_config(get_config, arch)
    assert red.n_heads // red.n_kv_heads == h // hkv and red.head_dim == 16
    assert get_config(arch, reduced=True).n_heads == 4   # reduced(): G = 2


@pytest.mark.parametrize("arch,flags", [
    ("internlm2-20b", ["--w8a8"]), ("yi-34b", ["--w4a8"]),
    ("internlm2-20b", ["--w8a8", "--paged"]), ("xlstm-350m", ["--w8a8"])])
def test_launcher_cpu(capsys, arch, flags):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--reduced", "--int8-kv", "--requests", "2",
          "--max-new", "3", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert ("mode=tokenwise" if arch == "xlstm-350m" else "mode=packed") in out


# ---------------------------------------------------------------------------
# conversion, PTQ, layer-by-layer init
# ---------------------------------------------------------------------------

def test_w4_policy_keeps_int8_past_the_combine_headroom(rng):
    """ROADMAP C14: yi-34b's down projection (K = 20480) is past the int32
    group combine's headroom (K * 128 * 8 * 127 < 2^31: K <= 16513).  The
    reference's PTQ packs it to int4 and its own W4A8 GEMM then refuses
    the leaf; the port's PTQ keeps it int8, and equals the reference's
    group choice wherever K fits (internlm2-20b's 16384 does)."""
    from repro.quant.ptq import _fit_group as j_fit
    from repro_torch.kernels.int8_gemm import W4_MAX_K
    from repro_torch.quant.ptq import _fit_group
    assert W4_MAX_K == 16513
    yi = get_config("yi-34b")
    assert j_fit(yi.d_ff, 64) == 64 and _fit_group(yi.d_ff, 64) is None
    for k in (yi.d_model, get_config("internlm2-20b").d_ff, 13440, 16512):
        assert _fit_group(k, 64) == j_fit(k, 64)
    k, n = yi.d_ff, 8
    x_q = rng.integers(-128, 128, (2, k)).astype(np.int8)
    w4 = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    qmul = np.ones((k // 64, n), np.int8)
    with pytest.raises(AssertionError):
        ref.gemm_w4a8_ref(x_q, np.ones((2, 1), np.float32), w4, qmul,
                          np.ones(n, np.float32))
    lin = Linear(T(rng.normal(size=(k, n)).astype(np.float32)))
    mine = ptq_quantize_params(torch.nn.ModuleDict({"w_out": lin}),
                               policy=DEFAULT_W4_POLICY)
    assert mine["w_out"].quantized and not mine["w_out"].int4
    out = apply_linear(T(rng.normal(size=(2, k)).astype(np.float32)),
                       mine["w_out"], ExecMode("w4a8"))
    assert out.shape == (2, n) and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", list(GQA))
def test_convert_round_trip(trees, arch, prec):
    """A model without qkv bias at G = 6 / 7 converts both ways through the
    existing ``attn`` layout."""
    *_, cfg, m = _models(trees, arch, prec)
    tree = trees[arch, prec][1]
    assert tree_equal(to_reference(m, cfg), tree)
    a = m.layers[0].attn
    assert a.bq is None and a.bk is None and a.bv is None
    assert "bq" not in tree["periods"][0]["attn"]


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
@pytest.mark.parametrize("arch", list(GQA))
def test_ptq_bit_exact(trees, arch, prec):
    cfg = gqa_config(get_config, arch, prec)
    mine = ptq_quantize_params(
        from_reference(trees[arch, "bf16"][1], cfg, device="cpu"),
        policy=DEFAULT_W4_POLICY if prec == "w4a8" else None)
    assert tree_equal(to_reference(mine, cfg), trees[arch, prec][1])
    assert mine.layers[0].mlp.w_gate.int4 == (prec == "w4a8")
    assert mine.unembed.quantized and not mine.unembed.int4


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
@pytest.mark.parametrize("arch", list(GQA))
def test_layer_by_layer_init(arch, prec):
    cfg = gqa_config(get_config, arch, prec)
    whole = quantize_for(init_params(cfg, seed=2, device="cpu"), prec)
    by_block = init_params(cfg, seed=2, device="cpu", precision=prec)
    a, b = whole.state_dict(), by_block.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)


# ---------------------------------------------------------------------------
# forward and lm_loss against jax.jit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", list(GQA))
def test_forward_no_cache_and_loss(trees, arch, prec):
    jcfg, jp, cfg, tp = _models(trees, arch, prec)
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (2, 40)).astype(np.int32)
    lj = as_np(jax.jit(lambda p, t: jforward(p, jcfg, t)[0],
                       compiler_options=EXACT)(jp, toks))
    lt = forward(tp, cfg, T(toks).long())[0].numpy()
    assert np.isfinite(lt).all() and lt.shape == lj.shape
    assert np.abs(lj - lt).max() <= (BF16_TOL if prec == "bf16" else INT_TOL)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want = float(jax.jit(lambda p, t, l: jlm_loss(p, jcfg, t, l),
                         compiler_options=EXACT)(jp, toks, labels))
    got = float(lm_loss(tp, cfg, T(toks).long(), T(labels)))
    assert abs(got - want) <= (LOSS_RTOL if prec != "bf16" else 1e-2) * want


@pytest.mark.parametrize("int8_kv", [True, False])
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", list(GQA))
def test_forward_cached(trees, arch, prec, int8_kv):
    """A ragged prefill of 24 tokens, then three decode steps, batch 3, each
    feeding the reference's greedy token."""
    jcfg, jp, cfg, tp = _models(trees, arch, prec)
    rng = np.random.default_rng(2)
    b, t, s = 3, 24, 48
    toks = rng.integers(2, cfg.vocab_size, (b, t)).astype(np.int32)
    lens = np.array([24, 13, 5])
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None],
                   -1).astype(np.int32)
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st),
                compiler_options=EXACT)
    jst = jinit_states(jcfg, b, s, int8_kv=int8_kv)
    tst = init_states(cfg, b, s, int8_kv=int8_kv, device="cpu")
    for step in range(4):
        lj, jst = f(jp, toks, pos, jst)
        lt, tst = forward(tp, cfg, T(toks).long(), T(pos), tst)
        lj, lt = np.asarray(lj), lt.numpy()
        assert np.isfinite(lt).all()
        assert np.abs(lj - lt).max() <= W8A8_TOL, step
        nxt = lj[np.arange(b), np.maximum(lens - 1, 0)
                 if step == 0 else 0].argmax(-1)
        toks = nxt[:, None].astype(np.int32)
        pos = ((pos.max(1) + 1)[:, None]).astype(np.int32)
        lens = np.ones(b, int)


# ---------------------------------------------------------------------------
# packed serving against the reference engine; paged against dense
# ---------------------------------------------------------------------------

SERVE = dict(batch_lanes=3, max_seq=48, int8_kv=True, token_budget=8)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(2, cfg.vocab_size, n).tolist()
            for n in (9, 3, 17, 5)]


def _drain(eng, prompts, max_new=6):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i)
    return {r["id"]: r["tokens"] for r in eng.run_until_drained()}


def ref_margin(jcfg, jp, context) -> float:
    """The reference's top-2 margin of the next-token logits after
    ``context`` (one cached prefill over the int8 cache)."""
    n = len(context)
    st = jinit_states(jcfg, 1, SERVE["max_seq"], int8_kv=True)
    lg, _ = jax.jit(lambda p, t, s: jforward(
        p, jcfg, t, positions=np.arange(n, dtype=np.int32)[None], states=s),
        compiler_options=EXACT)(jp, np.asarray(context, np.int32)[None], st)
    top = np.sort(np.asarray(lg[0, -1]))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("arch", list(GQA))
def test_packed_serving_matches_the_reference(trees, arch, prec):
    """Greedy tokens of the packed engine (token budget 8, 3 lanes, 4
    requests: a lane is reused) equal ``repro.serve.ServingEngine``'s: every
    token at W8A8 and W4A8; at bf16 up to the first token where the
    reference's top-2 margin is below ``BF16_TOL`` (a near-tie that the
    float matmuls' rounding decides)."""
    jcfg, jp, cfg, tp = _models(trees, arch, prec)
    jeng = JServingEngine(jp, jcfg, JServeConfig(**SERVE))
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE), device="cpu")
    assert eng.mode == jeng.mode == "packed"
    prompts = _prompts(cfg)
    ops.reset_launch_counts()
    got, want = _drain(eng, prompts), _drain(jeng, prompts)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    if prec != "bf16":
        assert got == want
        return
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        i = next((i for i, (a, b) in enumerate(zip(got[rid], w)) if a != b),
                 None)
        if i is None:
            assert len(got[rid]) == len(w)
        else:
            assert ref_margin(jcfg, jp, prompts[rid] + w[:i]) < BF16_TOL


@pytest.mark.parametrize("arch", list(GQA))
def test_paged_equals_dense(trees, arch):
    *_, cfg, tp = _models(trees, arch, "w8a8")
    prompts = _prompts(cfg) + [_prompts(cfg)[0][:6] + [5, 6]]  # a shared prefix
    dense = _drain(ServingEngine(tp, cfg, ServeConfig(**SERVE),
                                 device="cpu"), prompts)
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE, paged=True,
                                             page_size=4), device="cpu")
    assert eng.paged
    assert _drain(eng, prompts) == dense


# ---------------------------------------------------------------------------
# the decode attentions' plain versions at G = 6 and 7
# ---------------------------------------------------------------------------

def _int8(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    s = (np.abs(x).max(-1, keepdims=True) / 127.0).astype(np.float32)
    return np.clip(np.round(x / s), -128, 127).astype(np.int8), s


@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("g", [6, 7])
def test_dense_decode_plain_at_g(rng, g, window):
    """8 lanes of 40 slots over 2 KV heads (lane 1 idle), q in f32."""
    b, s, hkv, d = 8, 40, 2, 16
    k_q, k_s = _int8(rng, (b, s, hkv, d))
    v_q, v_s = _int8(rng, (b, s, hkv, d))
    fill = rng.integers(1, s + 1, b)
    fill[1] = 0
    slot = np.arange(s)
    pos = np.where(slot[None] < fill[:, None], slot[None], -1).astype(np.int32)
    qpos = (fill - 1).astype(np.int32)
    q = rng.standard_normal((b, g * hkv, d)).astype(np.float32)
    args = (q, k_q, k_s, v_q, v_s, pos, qpos)
    want = jax.jit(lambda *a: ref.int8_kv_decode_attention_ref(
        *a, window=window))(*args)
    got = int8_kv_decode_attention_ref(*map(T, args), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("g", [6, 7])
def test_paged_decode_plain_at_g(rng, g):
    """Four lanes over a scrambled table of 8-slot pages (lane 2 idle)."""
    npg, ps, mp, hkv, d = 12, 8, 4, 2, 16
    pk, pks = _int8(rng, (npg, ps, hkv, d))
    pv, pvs = _int8(rng, (npg, ps, hkv, d))
    ppos = np.full((npg, ps), -1, np.int32)
    pt = np.array([[3, 7, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0], [9, 2, 11, 0]],
                  np.int32)
    for lane, fill in ((0, 13), (1, 6), (3, 20)):
        for j in range(fill):
            ppos[pt[lane, j // ps], j % ps] = j
    qpos = np.array([12, 5, -1, 19], np.int32)
    q = rng.standard_normal((4, g * hkv, d)).astype(np.float32)
    args = (q, pk, pks, pv, pvs, ppos, pt, qpos)
    want = jax.jit(ref.paged_decode_attention_ref)(*args)
    got = paged_decode_attention_ref(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert (got[2] == 0).all()
