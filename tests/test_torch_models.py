"""The port's model path against ``jax.jit`` of the JAX reference, on the CPU,
at starcoder2-3b-reduced (bf16, w8a8) and codeqwen1.5-7b-reduced (bf16,
w8a8, w4a8: SwiGLU, RMSNorm) with the reference's own weights
(``convert.py``).

Tolerances (absolute, on logits of magnitude ~0.6 at this size):
* w8a8 and w4a8: ``W8A8_TOL`` — every integer kernel is bit-exact and the float glue
  (RoPE, softmax, bf16 casts) matches XLA's closely enough that the logits
  come out identical at these seeds; the bound leaves room for one int8
  activation level to move if a bf16 rounding of the glue ever differs.
* bf16: ``BF16_TOL`` — XLA:CPU and PyTorch round bf16 matmuls and RoPE at
  different points (~1% of the logit range).
"""
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
from repro.models.attention import _quant_kv as j_quant_kv
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.quant.ptq import quantized_param_fraction as jfraction

from repro_torch.configs import get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.models import forward, init_states
from repro_torch.models import layers
from repro_torch.models.attention import _quant_kv, _write_cache, init_cache
from repro_torch.quant import (DEFAULT_W4_POLICY, ptq_quantize_params,
                               quantized_param_fraction)

W8A8_TOL = 0.02
BF16_TOL = 0.02
ARCH = "starcoder2-3b"
QWEN = "codeqwen1.5-7b"
PRECISIONS = ("bf16", "w8a8", "w4a8")


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


def _ref_trees(arch, precisions):
    """{precision: (jax params, numpy tree)} for the reduced arch, seed 0:
    w8a8 by the int8 policy, w4a8 by the default W4 policy."""
    out = {}
    for prec in precisions:
        cfg = jget_config(arch, precision=prec, reduced=True)
        p = jinit_params(jax.random.PRNGKey(0), cfg)
        if prec == "w8a8":
            p = jptq(p)
        elif prec == "w4a8":
            p = jptq(p, policy=J_W4_POLICY)
        out[prec] = (p, jax.device_get(p))
    return out


@pytest.fixture(scope="module")
def ref_params():
    return _ref_trees(ARCH, ("bf16", "w8a8"))


@pytest.fixture(scope="module")
def qwen_params():
    return _ref_trees(QWEN, PRECISIONS)


# ---------------------------------------------------------------------------
# layers: the integer glue is bit-exact against the jitted reference
# ---------------------------------------------------------------------------

class TestLayersExact:
    def _w(self, rng, k, n):
        w = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jnp.float32)
        q = jlayers.quantize_weight(w)
        return q, T(q["w_q"]), T(q["scale"])

    def test_linear_w8a8_bias_and_residual(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
        q, w_q, ws = self._w(rng, 64, 48)
        b = jnp.asarray(rng.standard_normal(48) * 0.1, jnp.float32)
        r = jnp.asarray(rng.standard_normal((2, 5, 48)), jnp.bfloat16)
        xt, rt = T(as_np(x)).bfloat16(), T(as_np(r)).bfloat16()
        want = jax.jit(jlayers.linear_w8a8)(x, q["w_q"], q["scale"], b)
        got = layers.linear_w8a8(xt, w_q, ws, T(b))
        assert np.array_equal(got.float().numpy(), as_np(want))
        want = jax.jit(lambda *a: jlayers.linear_w8a8(*a, residual=r))(
            x, q["w_q"], q["scale"])
        got = layers.linear_w8a8(xt, w_q, ws, residual=rt)
        assert np.array_equal(got.float().numpy(), as_np(want))

    def test_linear_gelu_w8a8(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 7, 64)), jnp.bfloat16)
        q, w_q, ws = self._w(rng, 64, 128)
        want = jax.jit(jlayers.linear_gelu_w8a8)(x, q["w_q"], q["scale"])
        got = layers.linear_gelu_w8a8(T(as_np(x)).bfloat16(), w_q, ws)
        assert np.array_equal(got.float().numpy(), as_np(want))

    @pytest.mark.parametrize("rms", [False, True])
    def test_norm_int(self, rng, rms):
        x = jnp.asarray(rng.standard_normal((2, 9, 64)) * 3, jnp.bfloat16)
        g = jnp.asarray(rng.standard_normal(64) * 0.5 + 1, jnp.float32)
        b = None if rms else jnp.asarray(rng.standard_normal(64) * 0.2,
                                         jnp.float32)
        want = jax.jit(lambda *a: jlayers.norm_int(*a, rms_only=rms))(x, g, b)
        got = layers.norm_int(T(as_np(x)).bfloat16(), T(g),
                              None if b is None else T(b), rms)
        assert np.array_equal(got.float().numpy(), as_np(want))

    def test_quant_kv(self, rng):
        k = jnp.asarray(rng.standard_normal((2, 5, 2, 16)), jnp.bfloat16)
        qj, sj = jax.jit(j_quant_kv)(k)
        q, s = _quant_kv(T(as_np(k)).bfloat16())
        assert np.array_equal(q.numpy(), np.asarray(qj))
        assert np.array_equal(s.numpy(), np.asarray(sj))

    def _w4(self, rng, k, n, group=64):
        w = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), jnp.float32)
        q = jlayers.quantize_weight_w4(w, group=group)
        return q, T(q["w4"]), T(q["qmul"]), T(q["scale"])

    def test_linear_w4a8_bias_and_residual(self, rng):
        x = jnp.asarray(rng.standard_normal((2, 5, 128)), jnp.bfloat16)
        q, w4, qm, ws = self._w4(rng, 128, 48)
        b = jnp.asarray(rng.standard_normal(48) * 0.1, jnp.float32)
        r = jnp.asarray(rng.standard_normal((2, 5, 48)), jnp.bfloat16)
        xt, rt = T(as_np(x)).bfloat16(), T(as_np(r)).bfloat16()
        want = jax.jit(jlayers.linear_w4a8)(x, q["w4"], q["qmul"], q["scale"], b)
        got = layers.linear_w4a8(xt, w4, qm, ws, T(b))
        assert np.array_equal(got.float().numpy(), as_np(want))
        want = jax.jit(lambda *a: jlayers.linear_w4a8(*a, residual=r))(
            x, q["w4"], q["qmul"], q["scale"])
        got = layers.linear_w4a8(xt, w4, qm, ws, residual=rt)
        assert np.array_equal(got.float().numpy(), as_np(want))

    def test_linear_gelu_w4a8(self, rng):
        x = jnp.asarray(rng.standard_normal((3, 7, 64)), jnp.bfloat16)
        q, w4, qm, ws = self._w4(rng, 64, 128, group=32)
        want = jax.jit(jlayers.linear_gelu_w4a8)(x, q["w4"], q["qmul"],
                                                 q["scale"])
        got = layers.linear_gelu_w4a8(T(as_np(x)).bfloat16(), w4, qm, ws)
        assert np.array_equal(got.float().numpy(), as_np(want))

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_linear_gated(self, rng, act):
        x = jnp.asarray(rng.standard_normal((2, 6, 64)), jnp.bfloat16)
        xt = T(as_np(x)).bfloat16()
        (qu, uq, us), (qg, gq, gs) = self._w(rng, 64, 96), self._w(rng, 64, 96)
        want = jax.jit(lambda *a: jlayers.linear_gated_w8a8(*a, act))(
            x, qu["w_q"], qu["scale"], qg["w_q"], qg["scale"])
        got = layers.linear_gated_w8a8(xt, uq, us, gq, gs, act)
        assert np.array_equal(got.float().numpy(), as_np(want))
        (ju, *tu), (jg, *tgt) = self._w4(rng, 64, 96), self._w4(rng, 64, 96)
        want = jax.jit(lambda u, g_: jlayers.linear_gated_w4a8(x, u, g_, act))(
            ju, jg)
        got = layers.linear_gated_w4a8(
            xt, layers.Linear(w4=tu[0], qmul=tu[1], scale=tu[2]),
            layers.Linear(w4=tgt[0], qmul=tgt[1], scale=tgt[2]), act)
        assert np.array_equal(got.float().numpy(), as_np(want))

    def test_integer_silu_activation(self, rng):
        x = jnp.asarray(rng.standard_normal((4, 64)) * 4, jnp.bfloat16)
        mode = jlayers.ExecMode(precision="w8a8")
        want = jax.jit(lambda v: jlayers.activation(v, "silu", mode))(x)
        got = layers.activation(T(as_np(x)).bfloat16(), "silu",
                                layers.ExecMode(precision="w8a8"))
        assert np.array_equal(got.float().numpy(), as_np(want))

    @pytest.mark.parametrize("group,clip", [(32, 1.0), (64, 1.0), (128, 0.9)])
    def test_quantize_weight_w4_eager(self, rng, group, clip):
        w = jnp.asarray(rng.standard_normal((256, 48)), jnp.float32)
        want = jlayers.quantize_weight_w4(w, group=group, clip_ratio=clip)
        got = layers.quantize_weight_w4(T(w), group=group, clip_ratio=clip)
        for k in ("w4", "qmul", "scale"):
            assert got[k].dtype == {"w4": torch.int8, "qmul": torch.int8,
                                    "scale": torch.float32}[k]
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k

    def test_quantize_weight_eager(self, rng):
        w = jnp.asarray(rng.standard_normal((64, 48)), jnp.float32)
        want = jlayers.quantize_weight(w)
        got = layers.quantize_weight(T(w))
        assert np.array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
        assert np.array_equal(got["scale"].numpy(), np.asarray(want["scale"]))


class TestCacheWrite:
    def test_pads_dropped_in_place(self, rng):
        cfg = get_config(ARCH, reduced=True)
        cache = init_cache(cfg, 2, 8, int8=True, device="cpu")
        k = torch.randn(2, 3, cfg.n_kv_heads, cfg.head_dim)
        pos = torch.tensor([[0, 1, -1], [-1, -1, -1]], dtype=torch.int32)
        before = {n: t.clone() for n, t in cache.items()}
        out = _write_cache(cache, k, k, pos)
        assert out is cache
        assert cache["pos_ids"][0].tolist() == [0, 1, -1, -1, -1, -1, -1, -1]
        for n in cache:                      # lane 1 fed only pads
            assert torch.equal(cache[n][1], before[n][1])
        q, s = _quant_kv(k[0, :2])
        assert torch.equal(cache["k"][0, :2], q)
        assert torch.equal(cache["k_s"][0, :2], s)


# ---------------------------------------------------------------------------
# PTQ and convert
# ---------------------------------------------------------------------------

class TestPTQConvert:
    def test_ptq_bit_exact(self, ref_params):
        cfg = get_config(ARCH, precision="w8a8", reduced=True)
        float_tree = ref_params["bf16"][1]
        mine = ptq_quantize_params(from_reference(float_tree, cfg, device="cpu"))
        want = jax.device_get(jptq(jax.tree.map(jnp.asarray, float_tree)))
        assert tree_equal(to_reference(mine), want)

    @pytest.mark.parametrize("prec", ["bf16", "w8a8"])
    def test_convert_round_trip(self, ref_params, prec):
        cfg = get_config(ARCH, precision=prec, reduced=True)
        tree = ref_params[prec][1]
        assert tree_equal(to_reference(from_reference(tree, cfg, device="cpu")),
                          tree)

    @pytest.mark.parametrize("prec", ["w8a8", "w4a8"])
    def test_ptq_bit_exact_codeqwen(self, qwen_params, prec):
        cfg = get_config(QWEN, precision=prec, reduced=True)
        float_tree = qwen_params["bf16"][1]
        policy = DEFAULT_W4_POLICY if prec == "w4a8" else None
        mine = ptq_quantize_params(from_reference(float_tree, cfg, device="cpu"),
                                   policy=policy)
        jpol = J_W4_POLICY if prec == "w4a8" else None
        want = jax.device_get(jptq(jax.tree.map(jnp.asarray, float_tree),
                                   policy=jpol))
        assert tree_equal(to_reference(mine), want)
        assert quantized_param_fraction(mine) == pytest.approx(
            jfraction(want), rel=1e-12)

    @pytest.mark.parametrize("prec", PRECISIONS)
    def test_convert_round_trip_codeqwen(self, qwen_params, prec):
        cfg = get_config(QWEN, precision=prec, reduced=True)
        tree = qwen_params[prec][1]
        m = from_reference(tree, cfg, device="cpu")
        assert tree_equal(to_reference(m), tree)
        assert m.layers[0].mlp.w_gate is not None
        assert m.layers[0].attn.wq.int4 == (prec == "w4a8")
        assert not m.unembed.int4 and m.unembed.quantized == (prec != "bf16")
        assert quantized_param_fraction(m) == pytest.approx(jfraction(tree),
                                                            rel=1e-12)

    def test_policy_classes_and_group_fit(self):
        from repro.quant.ptq import _fit_group as j_fit
        from repro.quant.ptq import weight_class as j_class
        from repro_torch.quant.ptq import W4_GROUPS, _fit_group, weight_class
        for mine, path in (("layers.2.attn.wq", "periods/0/attn/wq"),
                           ("layers.0.mlp.w_gate", "periods/0/mlp/w_gate"),
                           ("unembed", "unembed"), ("embed", "embed")):
            assert weight_class(mine) == j_class(path)
        for k in (64, 96, 100, 13440, 7, 4096):
            for g in W4_GROUPS:
                assert _fit_group(k, g) == j_fit(k, g)

    def test_layers_unstacked(self, ref_params):
        cfg = get_config(ARCH, precision="w8a8", reduced=True)
        m = from_reference(ref_params["w8a8"][1], cfg, device="cpu")
        assert len(m.layers) == cfg.n_layers
        assert m.layers[1].attn.wq.w_q.dtype == torch.int8
        assert m.unembed.quantized and m.embed.dtype == torch.float32


# ---------------------------------------------------------------------------
# forward: logits against jax.jit(repro.models.forward)
# ---------------------------------------------------------------------------

def _run_both(ref_params, prec, int8_kv, cached=True, arch=ARCH):
    jcfg = jget_config(arch, precision=prec, reduced=True)
    cfg = get_config(arch, precision=prec, reduced=True)
    jp, tree = ref_params[prec]
    tp = from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(1)
    b, t, s = 3, 8, 32
    toks = rng.integers(2, cfg.vocab_size, (b, t)).astype(np.int32)
    lens = np.array([8, 5, 2])
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None],
                   -1).astype(np.int32)
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st))
    jst = jinit_states(jcfg, b, s, int8_kv=int8_kv) if cached else None
    tst = init_states(cfg, b, s, int8_kv=int8_kv, device="cpu") if cached else None
    out = []
    for step in range(3):
        lj, jst = f(jp, toks, pos, jst)
        lt, tst = forward(tp, cfg, T(toks).long(), T(pos), tst)
        out.append((np.asarray(lj), lt.numpy()))
        if not cached:
            break
        nxt = np.asarray(lj)[np.arange(b), np.maximum(lens - 1, 0)
                             if step == 0 else 0].argmax(-1)
        toks = nxt[:, None].astype(np.int32)
        pos = ((pos.max(1) + 1)[:, None]).astype(np.int32)
        lens = np.ones(b, int)
    return out


class TestForward:
    @pytest.mark.parametrize("int8_kv", [True, False])
    def test_w8a8(self, ref_params, int8_kv):
        for lj, lt in _run_both(ref_params, "w8a8", int8_kv):
            assert np.isfinite(lt).all() and lt.shape == lj.shape
            assert np.abs(lj - lt).max() <= W8A8_TOL

    @pytest.mark.parametrize("int8_kv", [True, False])
    def test_bf16(self, ref_params, int8_kv):
        for lj, lt in _run_both(ref_params, "bf16", int8_kv):
            assert np.abs(lj - lt).max() <= BF16_TOL

    @pytest.mark.parametrize("int8_kv", [True, False])
    @pytest.mark.parametrize("prec", PRECISIONS)
    def test_codeqwen(self, qwen_params, prec, int8_kv):
        tol = BF16_TOL if prec == "bf16" else W8A8_TOL
        for lj, lt in _run_both(qwen_params, prec, int8_kv, arch=QWEN):
            assert np.isfinite(lt).all() and lt.shape == lj.shape
            assert np.abs(lj - lt).max() <= tol

    def test_bf16_no_cache(self, ref_params):
        (lj, lt), = _run_both(ref_params, "bf16", False, cached=False)
        assert np.abs(lj - lt).max() <= BF16_TOL

    def test_w8a8_no_cache(self, ref_params):
        (lj, lt), = _run_both(ref_params, "w8a8", False, cached=False)
        assert np.isfinite(lt).all() and lt.shape == lj.shape
        assert np.abs(lj - lt).max() <= W8A8_TOL
        _greedy_agrees(lj, lt)

    @pytest.mark.parametrize("prec", PRECISIONS)
    def test_codeqwen_no_cache(self, qwen_params, prec):
        tol = BF16_TOL if prec == "bf16" else W8A8_TOL
        (lj, lt), = _run_both(qwen_params, prec, False, cached=False,
                              arch=QWEN)
        assert np.isfinite(lt).all() and lt.shape == lj.shape
        assert np.abs(lj - lt).max() <= tol
        _greedy_agrees(lj, lt)


def _greedy_agrees(lj, lt):
    """Greedy tokens agree wherever the reference's top-2 margin is more
    than twice the largest logit difference."""
    err = np.abs(lj - lt).max()
    top2 = np.sort(lj, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert np.array_equal(lj.argmax(-1)[clear], lt.argmax(-1)[clear])
