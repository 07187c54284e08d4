"""zamba2-2.7b in the port against the JAX reference, on the CPU, at
``zamba2-2.7b-reduced`` (d_model 64, 6 layers: five Mamba-2 blocks and one
shared attention block, 2 SSM heads, N = 16, attention head dim 16, tied
embeddings) with the reference's own weights (``convert.py``) and its own
PTQ.  Inputs come from a numpy seed.

The reference runs under ``jax.jit`` compiled with
``xla_allow_excess_precision`` off (``EXACT``): by default XLA:CPU drops
some bf16 round trips its code writes (the Mamba-2 block's ``y.astype(bf16)``
before the out-projection's activation quant among them), which the port
keeps, as a TPU does; with them dropped the reduced model's logits move by
up to 0.3 at W8A8, with them kept the integer forwards agree exactly at
these seeds.

Tolerances (absolute, on logits of magnitude ~0.7):
* ``LOGIT_TOL`` 0.02, the model tolerance of ``test_torch_models.py``:
  bf16 matmuls round at other points in XLA:CPU and PyTorch; at W8A8 and
  W4A8 every integer kernel is bit-exact and the f32 recurrence agrees to
  ~1e-6, so only an int8 activation level moved by a bf16 rounding of the
  glue could differ;
* ``lm_loss``: ``LOSS_RTOL`` relative;
* PTQ, the converted trees and the quantized-parameter fraction: exact.
"""
import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.models.lm import lm_loss as jlm_loss
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.quant.ptq import quantized_param_fraction as jfraction

from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.kernels import ops
from repro_torch.models import forward, init_states, lm_loss
from repro_torch.models.blocks import Block, MambaBlock
from repro_torch.quant import (ptq_quantize_params, quantize_for,
                               quantized_param_fraction)

ZAMBA = "zamba2-2.7b"
PRECISIONS = ("bf16", "w8a8", "w4a8")
LOGIT_TOL = 0.02
LOSS_RTOL = 1e-4
EXACT = {"xla_allow_excess_precision": False}


def T(a):
    return torch.from_numpy(np.array(a))


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
def zamba():
    """{precision: (reference params, the port's model PTQ'd by the port,
    reference cfg, port cfg)}, seed 0; the port's model is converted from
    the FLOAT reference tree and quantized by the port."""
    out = {}
    for prec in PRECISIONS:
        jcfg = jget_config(ZAMBA, precision=prec, reduced=True)
        cfg = get_config(ZAMBA, precision=prec, reduced=True)
        p = jinit_params(jax.random.PRNGKey(0), jcfg)
        tp = quantize_for(from_reference(jax.device_get(p), cfg,
                                         device="cpu"), prec)
        out[prec] = (_jptq(p, prec), tp, jcfg, cfg)
    return out


def _tokens(cfg, b, t, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# config, conversion and PTQ
# ---------------------------------------------------------------------------

def test_config_is_registered():
    from repro_torch.configs import ARCH_IDS
    assert "zamba2-2.7b" in ARCH_IDS
    cfg = get_config(ZAMBA)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.ssm_state) == (54, 2560, 32, 80, 10240,
                                               32000, 64)
    assert cfg.block_kinds.count("mamba2") == 45 and cfg.tie_embeddings
    red = get_config(ZAMBA + "-reduced")
    assert (red.n_layers, red.d_model, red.ssm_heads, red.ssm_state,
            red.head_dim) == (6, 64, 2, 16, 16)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_convert_round_trip(zamba, prec):
    """The reference's hybrid tree — periods stacked per pattern position,
    None at the shared position, ``shared``, no ``unembed`` — unstacks into
    one block per layer, the shared block held once, and back."""
    p, _, _, cfg = zamba[prec]
    tree = jax.device_get(p)
    m = from_reference(tree, cfg, device="cpu")
    kinds = [type(b) for b in m.layers]
    assert kinds == [MambaBlock] * 5 + [Block]
    assert m.unembed is None and tree["periods"][5] is None
    assert tree_equal(to_reference(m, cfg), tree)


@pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
def test_ptq_matches_reference(zamba, prec):
    """The port's PTQ of the float model equals the reference's PTQ tree:
    mamba in_proj/out_proj are class ``attn`` (int4 under the default W4
    policy), conv_w and the Mamba-2 vectors stay float, the shared block is
    quantized once, the tied head stays the float embedding."""
    p, tp, _, cfg = zamba[prec]
    assert tree_equal(to_reference(tp, cfg), jax.device_get(p))
    mb, sb = tp.layers[0].mamba, tp.layers[5]
    want4 = prec == "w4a8"
    assert mb.in_proj.int4 == want4 and mb.out_proj.int4 == want4
    assert mb.in_proj.quantized and mb.out_proj.quantized
    assert mb.conv_w.dtype == torch.float32 and tp.embed.dtype == torch.float32
    assert sb.attn.wq.int4 == want4 and sb.mlp.w_in.int4 == want4
    assert quantized_param_fraction(tp) == pytest.approx(jfraction(p),
                                                         rel=1e-12)


def test_shared_block_is_one_module():
    cfg = get_config(ZAMBA, reduced=True)
    from repro_torch.models import init_params
    m = init_params(cfg, seed=0, device="cpu")
    shared = [b for k, b in zip(cfg.block_kinds, m.layers) if k == "shared_attn"]
    assert shared and all(b is shared[0] for b in shared)
    w8 = ptq_quantize_params(m)
    assert w8.layers[5].attn.wq.quantized and w8.unembed is None


# ---------------------------------------------------------------------------
# forward and lm_loss against jax.jit of the reference
# ---------------------------------------------------------------------------

def _greedy_agrees(lj, lt):
    err = np.abs(lj - lt).max()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert np.array_equal(lj.argmax(-1)[clear], lt.argmax(-1)[clear])


@pytest.mark.parametrize("prec", PRECISIONS)
def test_no_cache_forward(zamba, prec):
    """Logits of the no-cache forward (T = 40: the scan pads to the chunk)
    within ``LOGIT_TOL``; greedy tokens equal where the margin is clear."""
    p, tp, jcfg, cfg = zamba[prec]
    tok = _tokens(cfg, 3, 40)
    lj, _ = jax.jit(lambda p, t: jforward(p, jcfg, t),
                    compiler_options=EXACT)(p, tok)
    ops.reset_launch_counts()
    lt, _ = forward(tp, cfg, T(tok).long())
    lj, lt = np.asarray(lj), lt.numpy()
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    assert np.abs(lj - lt).max() <= LOGIT_TOL
    _greedy_agrees(lj, lt)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("prec", PRECISIONS)
def test_lm_loss(zamba, prec):
    p, tp, jcfg, cfg = zamba[prec]
    tok = _tokens(cfg, 2, 33, seed=3)
    want = jax.jit(lambda p, a, b: jlm_loss(p, jcfg, a, b),
                   compiler_options=EXACT)(p, tok[:, :-1], tok[:, 1:])
    got = lm_loss(tp, cfg, T(tok[:, :-1]).long(), T(tok[:, 1:]).long())
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("prec,int8_kv", [("bf16", False), ("w8a8", True),
                                          ("w4a8", True)])
def test_forward_with_states(zamba, prec, int8_kv):
    """A prefill of 8 tokens (the chunked scan, the KV cache written) then
    4 single-token steps (the one-step update, decode attention), each
    feeding the reference's greedy token: logits within ``LOGIT_TOL``,
    greedy tokens equal where the margin is clear."""
    p, tp, jcfg, cfg = zamba[prec]
    b, s = 2, 32
    toks = _tokens(cfg, b, 8, seed=5)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (b, 8))
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st),
                compiler_options=EXACT)
    jst = jinit_states(jcfg, b, s, int8_kv=int8_kv)
    tst = init_states(cfg, b, s, int8_kv=int8_kv, device="cpu")
    for step in range(5):
        lj, jst = f(p, toks, pos, jst)
        lt, tst = forward(tp, cfg, T(toks).long(), T(pos), tst)
        lj, lt = np.asarray(lj)[:, -1], lt.numpy()[:, -1]
        assert np.abs(lj - lt).max() <= LOGIT_TOL, step
        _greedy_agrees(lj, lt)
        toks = lj.argmax(-1)[:, None].astype(np.int32)
        pos = (pos[:, -1:] + 1).astype(np.int32)
    ssd_j = np.asarray(jst[0]["ssd"])[0]       # period 0, position 0
    np.testing.assert_allclose(tst[0]["ssd"].numpy(), ssd_j, rtol=1e-3,
                               atol=1e-3)


def test_card_order_forward_on_the_cpu(zamba):
    """``card_order``: the int8-cache rows take the decode kernels' plain
    versions on the CPU (the card's order) — a t > 1 step row by row, then
    a t == 1 step — within ``LOGIT_TOL`` of the reference's ``_sdpa`` order,
    and launching nothing."""
    _, tp, _, cfg = zamba["w8a8"]
    toks = T(_tokens(cfg, 2, 8, seed=7)).long()
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    outs = []
    for card_order in (False, True):
        st = init_states(cfg, 2, 32, int8_kv=True, device="cpu")
        ops.reset_launch_counts()
        lg, st = forward(tp, cfg, toks, pos, st, card_order=card_order)
        lg2, _ = forward(tp, cfg, lg[:, -1:].argmax(-1), pos[:, -1:] + 1, st,
                         card_order=card_order)
        assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
        outs.append(torch.cat([lg, lg2], 1))
    assert float((outs[0] - outs[1]).abs().max()) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# serving: tokenwise (recurrent archs), the lane-masked state commit
# ---------------------------------------------------------------------------

SERVE = dict(batch_lanes=3, max_seq=48, int8_kv=True, token_budget=8)


def _serve_prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(2, cfg.vocab_size, n).tolist() for n in (5, 11, 3, 8)]


def _drain(eng, prompts, max_new=8):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, request_id=i)
    return {r["id"]: r["tokens"] for r in eng.run_until_drained()}


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serving_tokenwise_matches_reference(zamba, temperature):
    """zamba2-2.7b-reduced w8a8 served by both engines (a token budget is
    asked for; the recurrent arch forces tokenwise in both): the same
    tokens, greedy and sampled.  The reference's step is compiled with
    ``EXACT`` (module note); the integer forward then agrees exactly."""
    p, tp, jcfg, cfg = zamba["w8a8"]
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServingEngine as JServingEngine
    from repro_torch.serve import ServeConfig, ServingEngine
    kw = dict(SERVE, temperature=temperature, seed=2)
    jeng = JServingEngine(p, jcfg, JServeConfig(**kw))
    jeng._step_fn = jax.jit(jeng._step_fn.__wrapped__, static_argnums=(6, 7),
                            compiler_options=EXACT)
    eng = ServingEngine(tp, cfg, ServeConfig(**kw), device="cpu")
    assert eng.mode == jeng.mode == "tokenwise" and eng.chunk_buckets == ()
    prompts = _serve_prompts(cfg)
    ops.reset_launch_counts()
    assert _drain(eng, prompts) == _drain(jeng, prompts)
    assert set(eng.stats["forwards"]) == {1}
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_serving_lane_isolation(zamba):
    """A request's tokens do not depend on its neighbours: each request
    drained alone equals the same request served beside the others."""
    _, tp, _, cfg = zamba["w8a8"]
    from repro_torch.serve import ServeConfig, ServingEngine
    prompts = _serve_prompts(cfg)
    together = _drain(ServingEngine(tp, cfg, ServeConfig(**SERVE),
                                    device="cpu"), prompts)
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE), device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(p, max_new=8, request_id=i)
        eng.run_until_drained()
    alone = {r["id"]: r["tokens"] for r in eng.finished}
    assert alone == together


def test_lane_reset_clears_the_mamba_state(zamba):
    """``_reset_lane`` returns a lane's conv and SSD state (and its caches)
    to ``init_mamba2_state``'s zeros, and leaves the other lanes alone."""
    _, tp, _, cfg = zamba["w8a8"]
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(tp, cfg, ServeConfig(**SERVE), device="cpu")
    for i, p in enumerate(_serve_prompts(cfg)[:3]):
        eng.submit(p, max_new=30, request_id=i)
    for _ in range(6):
        eng.step()
    mamba = [st for st in eng.states if "ssd" in st]
    assert len(mamba) == 5
    before = [{k: v.clone() for k, v in st.items()} for st in mamba]
    assert all(st["ssd"][1].abs().sum() > 0 and st["conv"][1].abs().sum() > 0
               for st in mamba)
    eng._reset_lane(1)
    for st, old in zip(mamba, before):
        for k in ("conv", "ssd"):
            assert not st[k][1].any()
            assert torch.equal(st[k][0], old[k][0])
            assert torch.equal(st[k][2], old[k][2])
    kv = next(st["kv"] for st in eng.states if "kv" in st)
    assert (kv["pos_ids"][1] == -1).all() and (kv["pos_ids"][0] >= 0).any()


def test_masked_commit_keeps_lanes_outside_the_plan():
    """Recurrent leaves are selected per lane; KV caches (written in place)
    pass through."""
    from repro_torch.serve.engine import _masked_commit
    old = [{"conv": torch.zeros(3, 2, 4), "ssd": torch.zeros(3, 2, 2, 2)},
           {"kv": {"pos_ids": torch.zeros(3, 5, dtype=torch.int32)}}]
    new = [{"conv": torch.ones(3, 2, 4), "ssd": torch.ones(3, 2, 2, 2)},
           {"kv": old[1]["kv"]}]
    out = _masked_commit(old, new, torch.tensor([True, False, True]))
    for k in ("conv", "ssd"):
        assert out[0][k][[0, 2]].eq(1).all() and out[0][k][1].eq(0).all()
    assert out[1]["kv"] is old[1]["kv"]


def test_recurrent_serving_falls_back_to_dense_vanilla(zamba):
    """Paged and speculation are requested: the recurrent arch keeps the
    dense cache and never speculates (it cannot rewind its recurrence),
    and warmup does not shift its sampled streams."""
    _, tp, _, cfg = zamba["w8a8"]
    from repro_torch.serve import ServeConfig, ServingEngine
    prompts = _serve_prompts(cfg)[:2]
    kw = dict(SERVE, temperature=0.7, seed=1)
    want = _drain(ServingEngine(tp, cfg, ServeConfig(**kw), device="cpu"),
                  prompts)
    eng = ServingEngine(tp, cfg, ServeConfig(**kw, paged=True, spec_k=4),
                        device="cpu")
    assert not eng.paged and eng._spec_k == 0 and eng.mode == "tokenwise"
    eng.warmup()
    assert _drain(eng, prompts) == want
    assert eng.stats["spec_drafted"] == 0
