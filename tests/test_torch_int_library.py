"""The rest of the port's integer kernel library against the JAX reference,
on the CPU: ``requantize_i32``, the stand-alone ``int_gelu`` and
``int_silu``, ``int8_gemm``'s requant epilogues (``requant``,
``requant_gelu``, ``requant_add``), ``int8_conv2d`` and the ``ops`` entry
points over them; ``int8_flash_attention``'s choice of its streaming form
past 3328 keys; then the integer-nonlinearity forward over float weights
(integer norms, integer attention, integer GELU/SiLU, float linears) at
codeqwen1.5-7b-reduced and starcoder2-3b-reduced.  Inputs come from a numpy
seed and go to both sides.

Tolerances:
* every plain version against ``jax.jit`` of the reference's oracle and
  against its Pallas kernel in interpret mode: bit-exact, including inputs
  where the reference's int32 arithmetic wraps (raw GEMM accumulators into
  the GELU, a bias near the int32 range);
* the mixed forward's logits against ``jax.jit(forward)``: ``LOGITS_TOL``,
  the float forward's tolerance in ``test_torch_models.py`` (the linears are
  bf16 matmuls, which XLA:CPU and PyTorch round at different points, and a
  rounding can move one int8 activation level of the next integer kernel).

The CUDA kernels are held against these plain versions on the card by the
``cuda``-marked tests at the end (skipped without a card) and by
``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.core import inumerics as jnum
from repro.kernels import ref
from repro.kernels.common import set_interpret
from repro.kernels.conv2d import int8_conv2d as pallas_conv2d
from repro.kernels.int8_gemm import int8_gemm as pallas_gemm
from repro.kernels.int_gelu import int_gelu as pallas_gelu
from repro.kernels.int_silu import int_silu as pallas_silu
from repro.kernels.quantize import requantize_i32 as pallas_requant
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.core import inumerics as tnum
from repro_torch.kernels import ops
from repro_torch.kernels.conv2d import int8_conv2d, int8_conv2d_ref
from repro_torch.kernels.int8_gemm import (EPILOGUES, int8_gemm,
                                           int8_gemm_add_ref,
                                           int8_gemm_gelu_ref, int8_gemm_ref)
from repro_torch.kernels.int_gelu import int_gelu, int_gelu_ref
from repro_torch.kernels.int_silu import int_silu, int_silu_ref
from repro_torch.kernels.quantize import requantize_i32, requantize_i32_ref
from repro_torch.models import forward, layers
from repro_torch.models.layers import GELU_INT_SCALE, SILU_INT_SCALE

LOGITS_TOL = 0.02
QWEN, STAR = "codeqwen1.5-7b", "starcoder2-3b"
# (multiplier, accumulator bound) of requant params: a GEMM over K = 64 and
# 3072 into int8, a conv's 3x3x3 window, and a multiplier above 1
REQUANTS = [(1 / 512, 64 * 127 * 127), (1 / 40000, 3072 * 127 * 127),
            (0.01, 27 * 127 * 127), (3.0, 1000)]


@pytest.fixture(autouse=True)
def _interpret():
    set_interpret(True)


def T(a):
    return torch.from_numpy(np.array(a))


def same(port: torch.Tensor, jx) -> bool:
    a, b = port.numpy(), np.asarray(jx)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def params(i):
    """The same RequantParams on both sides."""
    mult, bound = REQUANTS[i]
    jp = jnum.compute_requant_params(mult, acc_bound=bound)
    tp = tnum.compute_requant_params(mult, acc_bound=bound)
    assert (jp.s1, jp.mult, jp.s2) == (tp.s1, tp.mult, tp.s2)
    return jp, tp


def int32_payload(rng, shape, wide: bool):
    """int32 values: the int8 range, or wide ones out to +-2^30 with the
    extremes of int32 in the first row."""
    if not wide:
        return rng.integers(-128, 128, shape).astype(np.int32)
    x = rng.integers(-2 ** 30, 2 ** 30, shape)
    x.reshape(-1)[:4] = [2 ** 31 - 1, -2 ** 31 + 1, 2 ** 31 - 2 ** 10, -2 ** 24]
    return x.astype(np.int32)


def int8(rng, *shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# requantize_i32 (B14)
# ---------------------------------------------------------------------------

class TestRequantize:
    @pytest.mark.parametrize("which", range(len(REQUANTS)))
    @pytest.mark.parametrize("wide", [False, True])
    def test_vs_jit_oracle_and_pallas(self, rng, which, wide):
        jp, tp = params(which)
        x = int32_payload(rng, (16, 256), wide)
        got = requantize_i32_ref(T(x), tp)
        assert got.dtype == torch.int8
        assert same(got, jax.jit(lambda a: ref.requantize_i32_ref(a, jp))(x))
        assert same(got, pallas_requant(x, jp))

    def test_entry_point_keeps_leading_dims(self, rng):
        jp, tp = params(0)
        x = rng.integers(-2 ** 20, 2 ** 20, (2, 3, 40)).astype(np.int32)
        got = ops.requant(T(x), tp)
        assert got.shape == (2, 3, 40)
        assert same(got, ref.requantize_i32_ref(x, jp))
        assert torch.equal(requantize_i32(T(x), tp), got)


# ---------------------------------------------------------------------------
# int_gelu, int_silu (B10)
# ---------------------------------------------------------------------------

class TestActivations:
    @pytest.mark.parametrize("scale", [GELU_INT_SCALE, 0.02, 0.25])
    @pytest.mark.parametrize("wide", [False, True])
    def test_gelu_vs_jit_oracle_and_pallas(self, rng, scale, wide):
        x = int32_payload(rng, (16, 256), wide)
        got = int_gelu_ref(T(x), scale)
        assert got.dtype == torch.int8
        assert same(got, jax.jit(lambda a: ref.int_gelu_ref(a, scale))(x))
        assert same(got, pallas_gelu(x, scale))
        assert torch.equal(int_gelu(T(x), scale), got)

    @pytest.mark.parametrize("scale", [SILU_INT_SCALE, 0.02, 0.25])
    @pytest.mark.parametrize("bits", [8, 16])
    def test_silu_vs_jit_oracle_and_pallas(self, rng, scale, bits):
        x = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1),
                         (16, 256)).astype(np.int32)
        got = int_silu_ref(T(x), scale)
        assert got.dtype == torch.int32
        assert same(got, jax.jit(lambda a: ref.int_silu_ref(a, scale))(x))
        assert same(got, pallas_silu(x, scale))
        assert torch.equal(int_silu(T(x), scale), got)

    def test_entry_points(self, rng):
        x = rng.integers(-128, 128, (3, 5, 24)).astype(np.int32)
        assert same(ops.gelu_i8(T(x), GELU_INT_SCALE),
                    ref.int_gelu_ref(x, GELU_INT_SCALE))
        assert same(ops.silu_i8(T(x), SILU_INT_SCALE),
                    ref.int_silu_ref(x, SILU_INT_SCALE))
        # int8 payloads are taken as they are
        assert torch.equal(ops.gelu_i8(T(x.astype(np.int8)), GELU_INT_SCALE),
                           ops.gelu_i8(T(x), GELU_INT_SCALE))


# ---------------------------------------------------------------------------
# int8_gemm's requant epilogues (B3, the rest)
# ---------------------------------------------------------------------------

class TestRequantGemm:
    def test_epilogues_are_the_references(self):
        from repro.kernels.int8_gemm import EPILOGUES as J_EPILOGUES
        assert EPILOGUES == J_EPILOGUES

    @pytest.mark.parametrize("m,k,n", [(32, 64, 32), (64, 256, 128)])
    @pytest.mark.parametrize("which", [0, 1, 3])
    def test_requant(self, rng, m, k, n, which):
        jp, tp = params(which)
        x, w = int8(rng, m, k), int8(rng, k, n)
        got = int8_gemm(T(x), T(w), "requant", requant=tp)
        assert same(got, jax.jit(lambda a, b: ref.int8_gemm_ref(a, b, jp))(
            x, w))
        assert same(got, pallas_gemm(x, w, requant=jp, out_dtype=jnp.int8,
                                     bm=32, bn=32, bk=64))
        assert torch.equal(int8_gemm_ref(T(x), T(w), tp), got)
        assert same(int8_gemm(T(x), T(w)), ref.int8_gemm_ref(x, w))

    @pytest.mark.parametrize("m,k,n", [(32, 64, 32), (64, 256, 128)])
    @pytest.mark.parametrize("scale", [GELU_INT_SCALE, 0.25])
    def test_requant_gelu(self, rng, m, k, n, scale):
        # the raw accumulator goes into the GELU: q * (q_erf + q_one) wraps
        # past int32 for the largest sums at K = 256
        x, w = int8(rng, m, k), int8(rng, k, n)
        x[0] = 127
        w[:, 0] = 127
        got = int8_gemm(T(x), T(w), "requant_gelu", gelu_scale=scale)
        assert same(got, jax.jit(
            lambda a, b: ref.int8_gemm_gelu_ref(a, b, scale))(x, w))
        assert same(got, pallas_gemm(x, w, epilogue="requant_gelu",
                                     gelu_scale=scale, bm=32, bn=32, bk=64))
        assert torch.equal(int8_gemm_gelu_ref(T(x), T(w), scale), got)

    @pytest.mark.parametrize("m,k,n", [(32, 64, 32), (64, 256, 128)])
    @pytest.mark.parametrize("which", [0, 1])
    def test_requant_add(self, rng, m, k, n, which):
        jp, tp = params(which)
        x, w, r = int8(rng, m, k), int8(rng, k, n), int8(rng, m, n)
        r[0] = 127                             # saturates
        r[1] = -128
        got = int8_gemm(T(x), T(w), "requant_add", requant=tp, residual=T(r))
        assert same(got, jax.jit(
            lambda a, b, c: ref.int8_gemm_add_ref(a, b, jp, c))(x, w, r))
        assert same(got, pallas_gemm(x, w, requant=jp, epilogue="requant_add",
                                     residual=r, bm=32, bn=32, bk=64))
        assert torch.equal(int8_gemm_add_ref(T(x), T(w), tp, T(r)), got)

    def test_entry_points(self, rng):
        jp, tp = params(0)
        x, w, r = int8(rng, 2, 5, 64), int8(rng, 64, 48), int8(rng, 2, 5, 48)
        assert same(ops.gemm_i8(T(x), T(w)), ref.int8_gemm_ref(
            x.reshape(-1, 64), w).reshape(2, 5, 48))
        assert same(ops.gemm_i8(T(x), T(w), tp), ref.int8_gemm_ref(
            x.reshape(-1, 64), w, jp).reshape(2, 5, 48))
        assert same(ops.gemm_i8_gelu(T(x), T(w), GELU_INT_SCALE),
                    ref.int8_gemm_gelu_ref(x.reshape(-1, 64), w,
                                           GELU_INT_SCALE).reshape(2, 5, 48))
        assert same(ops.gemm_i8_add(T(x), T(w), tp, T(r)),
                    ref.int8_gemm_add_ref(x.reshape(-1, 64), w, jp,
                                          r.reshape(-1, 48)).reshape(2, 5, 48))

    def test_epilogue_arguments_checked(self, rng):
        _, tp = params(0)
        x, w = T(int8(rng, 4, 8)), T(int8(rng, 8, 4))
        with pytest.raises(ValueError, match="requant params"):
            int8_gemm(x, w, "requant")
        with pytest.raises(ValueError, match="requant params"):
            int8_gemm(x, w, "none", requant=tp)
        with pytest.raises(ValueError, match="gelu_scale"):
            int8_gemm(x, w, "requant_gelu")
        with pytest.raises(ValueError, match="residual"):
            int8_gemm(x, w, "requant_add", requant=tp)


# ---------------------------------------------------------------------------
# int8_conv2d (B15)
# ---------------------------------------------------------------------------

def conv_inputs(rng, n, h, w, c, kh, kw, o, bias_range=2 ** 20):
    x = int8(rng, n, h, w, c)
    wt = int8(rng, kh, kw, c, o)
    b = rng.integers(-bias_range, bias_range, (o,)).astype(np.int32)
    return x, wt, b


def pallas_conv(x, w, b, jp):
    """The reference's Pallas conv in interpret mode, one image at a time.
    Each grid step reads and writes one image alone, so this is the same
    kernel; over a batch of 2 with a 1x1 window and some small widths (say
    C = 4, O = 8 over a 2x2 image) XLA:CPU emits invalid LLVM IR for the
    interpreted grid and refuses to compile it, and a process that meets
    that error often enough later aborts."""
    return np.concatenate([np.asarray(pallas_conv2d(x[i:i + 1], w, b, jp))
                           for i in range(x.shape[0])])


def check_conv(x, w, b, which=None):
    jp, tp = (None, None) if which is None else params(which)
    got = int8_conv2d_ref(T(x), T(w), T(b), tp)
    assert got.dtype == (torch.int32 if which is None else torch.int8)
    want = jax.jit(lambda a, c, d: ref.int8_conv2d_ref(a, c, d, jp))(x, w, b)
    assert same(got, want)
    assert same(got, pallas_conv(x, w, b, jp))
    assert torch.equal(int8_conv2d(T(x), T(w), T(b), tp), got)
    assert torch.equal(ops.conv2d_i8(T(x), T(w), T(b), tp), got)


class TestConv2d:
    @pytest.mark.parametrize("shape", [
        (1, 20, 18, 3, 3, 3, 8),      # Table II's input: C = 3, 3x3
        (2, 9, 9, 16, 3, 3, 12),      # 3x3 over 16 channels
        (2, 4, 4, 48, 1, 1, 20),      # 1x1 (a patch embed)
        (1, 7, 6, 5, 2, 3, 7)])       # ragged C, a 2x3 window
    @pytest.mark.parametrize("which", [None, 2])
    def test_vs_jit_oracle_and_pallas(self, rng, shape, which):
        check_conv(*conv_inputs(rng, *shape), which)

    @pytest.mark.parametrize("which", [None, 0])
    def test_bias_near_the_int32_range(self, rng, which):
        # acc + bias wraps past int32 in the reference; so does the port
        x, w, b = conv_inputs(rng, 1, 6, 6, 3, 3, 3, 4)
        b[:] = [2 ** 31 - 1, -2 ** 31, 2 ** 31 - 100, -2 ** 31 + 100]
        check_conv(x, w, b, which)

    @settings(max_examples=12, deadline=None)
    @given(st.integers(1, 2), st.integers(1, 4), st.integers(1, 4),
           st.integers(1, 9), st.integers(1, 9), st.integers(1, 6),
           st.integers(0, 2 ** 32 - 1), st.booleans())
    def test_random_shapes(self, n, kh, kw, c, o, extra, seed, requant):
        rng = np.random.default_rng(seed)
        check_conv(*conv_inputs(rng, n, kh + extra, kw + extra // 2 + 1, c,
                                kh, kw, o), 2 if requant else None)

    def test_operands_checked(self, rng):
        x, w, b = (T(a) for a in conv_inputs(rng, 1, 5, 5, 3, 3, 3, 4))
        with pytest.raises(ValueError, match="int8_conv2d"):
            ops.conv2d_i8(x, w[:, :, :2], b)


# ---------------------------------------------------------------------------
# int8_flash_attention past 3328 keys: the streaming form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skv,want", [(1024, 1), (3328, 1), (3329, 1),
                                      (8192, 1)])
def test_attention_takes_the_streaming_form_past_the_score_block(
        monkeypatch, skv, want):
    """For a CUDA tensor the wrapper launches the kernel at any key count,
    in its one form, which streams K three times (the block form that
    served up to 3328 keys is retired): every launch counts as streaming."""
    import types
    from repro_torch.kernels import build
    from repro_torch.kernels import int8_flash_attention as ifa
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models.attention import int_score_scale
    seen = {}

    def entry(name, symbol, argtypes):
        def fn(*args):
            seen["args"] = args
            return 0
        return fn
    monkeypatch.setattr(ifa, "on_cuda", lambda *a: True)
    monkeypatch.setattr(build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a:
                        types.SimpleNamespace(cuda_stream=0))
    q = torch.zeros((1, 1, skv, 128), dtype=torch.int8)
    ops.reset_launch_counts()
    ops.attention_i8(q, q, q, int_score_scale(128))
    assert ifa.streams(skv, 128) == bool(want) and seen["args"][9] == skv
    assert LAUNCHES["int8_flash_attention"] == 1
    assert LAUNCHES["int8_flash_attention.streaming"] == want


# ---------------------------------------------------------------------------
# the integer-nonlinearity forward over float weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,scale", [("gelu", GELU_INT_SCALE),
                                        ("silu", SILU_INT_SCALE)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_integer_activation_vs_reference(rng, kind, scale, dtype):
    # layers.activation in an integer mode: the static-scale requant, the
    # integer kernel's plain version and the dequant, bit for bit
    x = (rng.standard_normal((4, 7, 96)) * 3).astype(np.float32)
    x[0, 0, :4] = [9.0, -9.0, 0.5 * scale, -0.5 * scale]   # clip, round
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = jax.jit(lambda a: jlayers.activation(
        a, kind, jlayers.ExecMode("w8a8")))(jx)
    got = layers.activation(T(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), kind, layers.ExecMode("w8a8"))
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch,act", [(QWEN, "int_silu"), (STAR, "int_gelu")])
def test_mixed_forward_vs_reference(arch, act):
    """The no-cache forward of a w8a8 config over float parameters (seed
    0): every norm, the attention and the MLP activation integer, the
    linears float."""
    jcfg = jget_config(arch, precision="w8a8", reduced=True)
    cfg = get_config(arch, precision="w8a8", reduced=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    tp = from_reference(jax.device_get(jp), cfg, device="cpu")
    assert tp.layers[0].mlp.w_in.weight is not None   # float weights
    toks = np.random.default_rng(2).integers(
        2, cfg.vocab_size, (3, 8)).astype(np.int32)
    lj = np.asarray(jax.jit(lambda p, tk: jforward(p, jcfg, tk)[0])(jp, toks))
    ops.reset_launch_counts()
    lt, _ = forward(tp, cfg, T(toks).long())
    assert ops.launch_counts()[act] == 0          # the CPU launches nothing
    lt = lt.numpy()
    assert np.isfinite(lt).all() and lt.shape == lj.shape
    assert np.abs(lj - lt).max() <= LOGITS_TOL


# ---------------------------------------------------------------------------
# on the card: each new CUDA kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card (chip_smoke.py covers them there)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestIntLibraryOnCard:
    def test_elementwise(self, rng, cuda_dev):
        _, tp = params(1)
        x = T(int32_payload(rng, (64, 1000), True))
        x8 = T(rng.integers(-128, 128, (64, 1000)).astype(np.int32))
        xg = x.to(cuda_dev)
        assert torch.equal(ops.requant(xg, tp).cpu(), requantize_i32_ref(x, tp))
        assert torch.equal(ops.gelu_i8(xg, 0.02).cpu(), int_gelu_ref(x, 0.02))
        assert torch.equal(ops.silu_i8(x8.to(cuda_dev), SILU_INT_SCALE).cpu(),
                           int_silu_ref(x8, SILU_INT_SCALE))

    def test_requant_gemm(self, rng, cuda_dev):
        _, tp = params(1)
        x, w, r = (T(a).to(cuda_dev) for a in (int8(rng, 100, 256),
                                               int8(rng, 256, 70),
                                               int8(rng, 100, 70)))
        assert torch.equal(ops.gemm_i8(x, w, tp), int8_gemm_ref(x, w, tp))
        assert torch.equal(ops.gemm_i8_gelu(x, w, 0.25),
                           int8_gemm_gelu_ref(x, w, 0.25))
        assert torch.equal(ops.gemm_i8_add(x, w, tp, r),
                           int8_gemm_add_ref(x, w, tp, r))

    def test_streaming_attention(self, rng, cuda_dev):
        from repro_torch.kernels.int8_flash_attention import (
            ATOL, RTOL, int8_attention_probs_ref, int8_flash_attention,
            int8_flash_attention_ref)
        from repro_torch.models.attention import int_score_scale
        sc = int_score_scale(128)
        s = 3400                                      # past the score block
        q = T(rng.integers(-128, 128, (1, 2, s, 128)).astype(np.int8))
        k = T(rng.integers(-128, 128, (1, 1, s, 128)).astype(np.int8))
        v = T(rng.integers(-128, 128, (1, 1, s, 128)).astype(np.int8))
        vs = T(rng.uniform(1e-3, 5e-2, (1, 1, s, 1)).astype(np.float32))
        q, k, v, vs = (a.to(cuda_dev) for a in (q, k, v, vs))
        p_out = torch.empty((1, 2, s, s), dtype=torch.int8, device=cuda_dev)
        got = int8_flash_attention(q, k, v, sc, v_scale=vs, p_out=p_out)
        assert torch.equal(p_out.int(), int8_attention_probs_ref(q, k, sc))
        torch.testing.assert_close(got, int8_flash_attention_ref(
            q, k, v, sc, v_scale=vs), rtol=RTOL, atol=ATOL)
        assert torch.equal(int8_flash_attention(q, k, v, sc),
                           int8_flash_attention_ref(q, k, v, sc))

    @pytest.mark.parametrize("shape", [(1, 20, 18, 3, 3, 3, 8),
                                       (2, 9, 9, 16, 3, 3, 12),
                                       (2, 4, 4, 48, 1, 1, 20)])
    def test_conv2d(self, rng, cuda_dev, shape):
        x, w, b = (T(a).to(cuda_dev) for a in conv_inputs(rng, *shape))
        _, tp = params(2)
        assert torch.equal(ops.conv2d_i8(x, w, b), int8_conv2d_ref(x, w, b))
        assert torch.equal(ops.conv2d_i8(x, w, b, tp),
                           int8_conv2d_ref(x, w, b, tp))
