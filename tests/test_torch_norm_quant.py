"""The models' integer norm fused with the row quantization of its output,
and the row quantization of bf16 rows, against ``jax.jit`` of the JAX
reference on the CPU.

* ``int_layernorm_rows`` (one launch on the card: B1 -> B9 -> dequant ->
  residual dtype -> B1): its plain version against the reference's
  ``layers.norm_int`` followed by ``kernels.ref.quantize_rows_ref``, all
  three outputs bit-equal, at starcoder2-3b's LayerNorm (D = 3072, with
  beta), codeqwen1.5-7b's RMSNorm (4096) and zamba2-2.7b's (2560), bf16 and
  f32 residual rows, with an all-zero row and a row of negative mean; and at
  D = 16384, where a lone spike's norm output passes 2^24 and its
  conversion to f32 rounds.
* ``quantize_rows`` on bf16 rows: the f32 path's bits, and the reference's
  ``_quant_kv`` on the KV write's [B, T, Hkv, 128] and [B, T, Hkv, 80].
* A reduced codeqwen1.5-7b W4A8 and starcoder2-3b W8A8 forward with an int8
  KV cache: 4 standalone row quantizations a layer (o_proj, down, k, v),
  none for q/k/v/gate/up/head, 2 fused norms a layer plus the final one,
  and logits bit-equal to ``jax.jit(forward)``.

The reference is compiled with ``xla_allow_excess_precision`` off: with it
on, XLA:CPU may drop the bf16 round trip between the norm and the
quantization, which the port (as a TPU) keeps.
"""
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
from repro.models import layers as jlayers
from repro.models.attention import _quant_kv as j_quant_kv
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.kernels import int_layernorm as ln_mod
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as quant_mod
from repro_torch.kernels.int_layernorm import (int_layernorm_ref,
                                               int_layernorm_rows_ref)
from repro_torch.kernels.quantize import quantize_rows_ref
from repro_torch.models import forward, init_states
from repro_torch.models import layers
from repro_torch.models.attention import _quant_kv

EXACT = {"xla_allow_excess_precision": False}
# (label, D, rms_only): the three models' norms at full width
NORMS = (("starcoder2-3b ln", 3072, False), ("codeqwen1.5-7b rms", 4096, True),
         ("zamba2-2.7b rms", 2560, True))
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def T(a):
    return torch.from_numpy(np.array(a))


def as_np(x):
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _ref(x, gamma, beta, rms):
    """(h, h_q, h_scale) of the reference: ``norm_int`` then
    ``quantize_rows_ref`` of its output, each jitted."""
    norm = jax.jit(lambda x, g, b: jlayers.norm_int(x, g, b, rms_only=rms))
    h = norm.lower(x, gamma, beta).compile(EXACT)(x, gamma, beta)
    hf = h.astype(jnp.float32)
    quant = jax.jit(ref.quantize_rows_ref).lower(hf).compile(EXACT)
    hq, hs = quant(hf)
    return as_np(h), np.asarray(hq), np.asarray(hs)


def _port(x, gamma, beta, rms):
    g_q, b_q, gb_s = layers.quantize_norm(gamma, beta)
    h, hq, hs = int_layernorm_rows_ref(x, g_q, b_q, gb_s, rms)
    return h.float().numpy(), hq.numpy(), hs.numpy()


def _norm_inputs(rng, m, d, rms, jdt):
    x = rng.standard_normal((m, d)) * 3
    x[0] = 0.0                                   # the 1e-8 floor
    x[1] -= 4.0                                  # a row of negative mean
    x = jnp.asarray(x, jdt)
    g = jnp.asarray(rng.standard_normal(d) * 0.5 + 1, jnp.float32)
    b = None if rms else jnp.asarray(rng.standard_normal(d) * 0.2,
                                     jnp.float32)
    return x, g, b


def _assert_same(got, want):
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        assert np.array_equal(a, b_)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("label,d,rms", NORMS, ids=[n[0] for n in NORMS])
def test_fused_norm_quant_matches_reference(rng, label, d, rms, dtype):
    jdt, tdt = DTYPES[dtype]
    x, g, b = _norm_inputs(rng, 6, d, rms, jdt)
    got = _port(T(as_np(x)).to(tdt), T(g), None if b is None else T(b), rms)
    _assert_same(got, _ref(x, g, b, rms))
    h = got[0]
    assert h[1].mean() != 0 and not (got[1][0] != 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rms", [False, True], ids=["ln", "rms"])
def test_fused_norm_quant_past_2_24(rng, rms, dtype):
    """D = 16384: a row whose only nonzero value is a spike quantizes to
    +-127 with zeros around it, so its variance floors to 0, std16 to 1
    and the spike's norm output (127 << 11 times gamma's 127) passes 2^24,
    where the int -> f32 conversion rounds."""
    jdt, tdt = DTYPES[dtype]
    d = 16384
    x, g, b = _norm_inputs(rng, 4, d, rms, jdt)
    x = np.array(as_np(x))
    x[2] = 0.0
    x[2, 77] = 5.0
    x[3] = 0.0
    x[3, 5000] = -2.5
    x = jnp.asarray(x, jdt)
    g = g.at[77].set(4.0).at[5000].set(-3.0)
    xt = T(as_np(x)).to(tdt)
    g_q, b_q, gb_s = layers.quantize_norm(T(g), None if b is None else T(b))
    xq, _ = quantize_rows_ref(xt)
    out = int_layernorm_ref(xq, g_q, b_q, rms)
    assert out[2:].abs().max() > 2 ** 24       # the case is what it claims
    got = _port(xt, T(g), None if b is None else T(b), rms)
    _assert_same(got, _ref(x, g, b, rms))


def test_fused_form_is_the_chain(rng):
    """``ops.norm_quant_rows`` on leading dims: the chain of standalone
    plain versions (B1, B9, dequant, cast, B1), as ``norm_int`` did it
    before the fusion."""
    x = T(rng.standard_normal((2, 3, 256)).astype(np.float32)).bfloat16()
    g_q, b_q, gb_s = layers.quantize_norm(
        T(rng.standard_normal(256).astype(np.float32)),
        T(rng.standard_normal(256).astype(np.float32) * 0.1))
    h, hq, hs = ops.norm_quant_rows(x, g_q, b_q, gb_s)
    xq, _ = ops.quant_rows(x.float())
    o = ops.layernorm_i8(xq.to(torch.int32), g_q, b_q)
    want = (o.float() * (gb_s * torch.tensor(np.float32(1 / 128)))).to(x.dtype)
    wq, ws = ops.quant_rows(want.float())
    assert h.dtype == x.dtype and hq.shape == (2, 3, 256)
    assert hs.shape == (2, 3, 1)
    assert torch.equal(h, want) and torch.equal(hq, wq) and torch.equal(hs, ws)


@pytest.mark.parametrize("d", [3072, 4096, 13440, 128, 80])
def test_quant_rows_bf16_equals_f32_path(rng, d):
    x = T(rng.standard_normal((9, d)).astype(np.float32) * 3).bfloat16()
    x[0] = 0.0
    q, s = ops.quant_rows(x)
    qf, sf = ops.quant_rows(x.float())
    qj, sj = jax.jit(ref.quantize_rows_ref)(x.float().numpy())
    assert torch.equal(q, qf) and torch.equal(s, sf)
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("hd", [128, 80])
def test_quant_kv_rows_match_reference(rng, hd):
    """The KV write's rows: [B, T, Hkv, head_dim] bf16 (8 lanes of 2 and of
    32 kv heads at codeqwen's and starcoder's 128, zamba2's 80)."""
    for hkv in (2, 32):
        k = jnp.asarray(rng.standard_normal((8, 1, hkv, hd)) * 2, jnp.bfloat16)
        qj, sj = jax.jit(j_quant_kv)(k)
        q, s = _quant_kv(T(as_np(k)).bfloat16())
        assert q.shape == (8, 1, hkv, hd) and s.shape == (8, 1, hkv, 1)
        assert np.array_equal(q.numpy(), np.asarray(qj))
        assert np.array_equal(s.numpy(), np.asarray(sj))


# ---------------------------------------------------------------------------
# the reduced forwards: each quantization once, logits bit-equal
# ---------------------------------------------------------------------------

FORWARDS = (("codeqwen1.5-7b", "w4a8"), ("starcoder2-3b", "w8a8"))


def _counting(monkeypatch):
    """Count the plain versions' calls: standalone row quantizations
    (``quantize.quantize_rows``'s) and fused norms."""
    calls = {"quantize_rows": [], "norm": 0}
    q_ref, n_ref = quant_mod.quantize_rows_ref, ln_mod.int_layernorm_rows_ref

    def q_count(x):
        calls["quantize_rows"].append(tuple(x.shape))
        return q_ref(x)

    def n_count(*a, **k):
        calls["norm"] += 1
        return n_ref(*a, **k)
    monkeypatch.setattr(quant_mod, "quantize_rows_ref", q_count)
    monkeypatch.setattr(ln_mod, "int_layernorm_rows_ref", n_count)
    return calls


@pytest.mark.parametrize("arch,prec", FORWARDS, ids=[a for a, _ in FORWARDS])
def test_reduced_forward_quantizes_once(monkeypatch, arch, prec):
    jcfg = jget_config(arch, precision=prec, reduced=True)
    cfg = get_config(arch, precision=prec, reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    jp = jptq(jp, policy=J_W4_POLICY) if prec == "w4a8" else jptq(jp)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    rng = np.random.default_rng(3)
    b, t, s = 2, 6, 16
    toks = rng.integers(2, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    pos[1, 4:] = -1                                  # pads: dropped writes
    jst = jinit_states(jcfg, b, s, int8_kv=True)
    f = jax.jit(lambda p, tk, ps, st: jforward(p, jcfg, tk, positions=ps,
                                               states=st))
    lj, _ = f(jp, toks, pos, jst)
    calls = _counting(monkeypatch)
    tst = init_states(cfg, b, s, int8_kv=True, device="cpu")
    lt, _ = forward(tp, cfg, T(toks).long(), T(pos), tst)
    n = cfg.n_layers
    hd, ff = cfg.head_dim, cfg.d_ff
    live = int((pos >= 0).sum())
    assert calls["norm"] == 2 * n + 1
    # per layer: o_proj's input, down's input, then k's and v's rows
    want = [(b * t, cfg.n_heads * hd), (b * t, ff)]
    order = sorted(calls["quantize_rows"])
    assert len(calls["quantize_rows"]) == 4 * n
    assert order == sorted(n * [want[0], want[1],
                                (live * cfg.n_kv_heads, hd),
                                (live * cfg.n_kv_heads, hd)])
    assert np.array_equal(lt.numpy(), np.asarray(lj))


# ---------------------------------------------------------------------------
# the wrappers: a CUDA tensor launches the kernel or raises
# ---------------------------------------------------------------------------

def _no_build(monkeypatch):
    from repro_torch.kernels import build

    def no_build(*a, **k):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)


def _norm_calls():
    cfg = get_config("codeqwen1.5-7b", precision="w8a8", reduced=True)
    p = layers.Norm(64, "rmsnorm")
    x = torch.ones((2, 3, 64), dtype=torch.bfloat16)
    return [(ln_mod, lambda: ops.norm_quant_rows(x, *p.int_consts(), True)),
            (ln_mod, lambda: layers.apply_norm(x, p, cfg,
                                               layers.ExecMode("w8a8"))),
            (quant_mod, lambda: ops.quant_rows(x)),
            (quant_mod, lambda: _quant_kv(x.reshape(2, 3, 4, 16)))]


@pytest.mark.parametrize("which", range(4))
def test_wrappers_never_fall_back(monkeypatch, which):
    """With the tensors taken for CUDA ones, the fused norm (through
    ``apply_norm`` too) and the row quantization of bf16 rows (through the
    KV write's ``_quant_kv`` too) go to their kernels — here the build,
    which raises — never to the plain versions."""
    mod, call = _norm_calls()[which]
    monkeypatch.setattr(mod, "on_cuda", lambda *a: True)
    _no_build(monkeypatch)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        call()


def test_fused_form_refuses_rows_it_cannot_hold(monkeypatch):
    """Rows the fused kernel cannot hold in registers (not a multiple of 16
    bytes, or past 2048 chunks) raise on the card; nothing falls back.  The
    C entry decides (``launch_rows`` returns cudaErrorInvalidValue and
    launches nothing); the wrapper hands it the rows as they are and turns
    the refusal into a ValueError.  The card test
    ``test_int_layernorm_rows_refuses`` holds the C side."""
    from repro_torch.kernels import build
    monkeypatch.setattr(ln_mod, "on_cuda", lambda *a: True)
    seen = []

    def refusing_entry(source, name, argtypes):
        assert (source, name) == ("int_layernorm", "repro_int_layernorm_rows")

        def fn(*args):
            seen.append(args[7:12])      # m, d, bf16, rms_only, vshift
            return 1                     # cudaErrorInvalidValue
        return fn
    monkeypatch.setattr(build, "entry", refusing_entry)
    monkeypatch.setattr(ln_mod, "int_layernorm_rows_ref",
                        lambda *a, **k: pytest.fail("fell back"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    for d, dt in ((100, torch.bfloat16), (16384 + 8, torch.bfloat16),
                  (8192 + 4, torch.float32)):
        p = layers.Norm(d, "rmsnorm")
        with pytest.raises(ValueError, match="int_layernorm_rows"):
            ops.norm_quant_rows(torch.ones((2, d), dtype=dt),
                                *p.int_consts(), True)
        assert seen.pop() == (2, d, int(dt == torch.bfloat16), 1,
                              ln_mod.vshift_of(d))


def test_device_constants_are_cached():
    """The forward's constants (``f32``) are built once per (value, device)
    and hold the f32 value."""
    from repro_torch.kernels.common import f32
    a = f32(1.0 / 16.0, "cpu")
    assert f32(1.0 / 16.0, torch.device("cpu")) is a
    assert torch.equal(a, torch.tensor(np.float32(1.0 / 16.0)))
    assert a.dtype == torch.float32 and a.dim() == 0
    assert f32(0.1, "cpu").item() == np.float32(0.1)
