"""The port's no-cache forward against the JAX reference, on the CPU: the
integer exp and softmax, the plain versions of int_softmax,
int8_flash_attention and flash_attention, ``lm_loss`` and
``calibrate_ptq``.  Inputs come from a numpy seed and go to both sides.

Tolerances:
* integer softmax, integer probabilities, the int32 attention form, the
  exp constants and the kernels' host-side shifts: bit-exact;
* the ``v_scale`` attention form: ``RTOL`` 1e-5, ``ATOL`` 1e-6, the
  reference's own Pallas-vs-oracle tolerance (the f32 PV sum runs in
  another order than XLA's einsum);
* flash_attention_ref against the reference's oracle: f32 inputs within
  ``F32_TOL`` (summation order and exp only), bf16 inputs within the
  kernel's own ``RTOL``/``ATOL`` (one bf16 rounding of the output);
* ``lm_loss``: ``LOSS_RTOL`` relative (the logits agree within the model
  tolerance of ``test_torch_models.py``; the loss averages them);
* ``calibrate_ptq``: the same policy and the same ranking of candidates.

The CUDA kernels are held against these plain versions on the card by the
``cuda``-marked tests at the end (skipped without a card) and by
``chip_smoke.py``.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import inumerics as jnum
from repro.kernels import ref
from repro.kernels.common import set_interpret
from repro.kernels.int8_flash_attention import (
    int8_flash_attention as pallas_int8_attention)
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.int_softmax import _exp_consts as j_exp_consts
from repro.kernels.int_softmax import int_softmax as pallas_softmax
from repro.models import init_params as jinit_params
from repro.models.lm import lm_loss as jlm_loss
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import calibrate_ptq as jcalibrate
from repro.models import forward as jforward

from repro_torch.configs import get_config
from repro_torch.convert import from_reference
from repro_torch.core import inumerics as tnum
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (ATOL as FA_ATOL,
                                                 RTOL as FA_RTOL,
                                                 flash_attention_ref,
                                                 flash_attention_tiled_ref)
from repro_torch.kernels.int8_flash_attention import (
    ATOL, RTOL, SMEM_LIMIT, block_smem, head_shift, int8_attention_probs_ref,
    int8_flash_attention, int8_flash_attention_ref, masked_exp_is_zero)
from repro_torch.kernels.int_softmax import _exp_consts, int_softmax_ref
from repro_torch.models import forward, lm_loss
from repro_torch.models.attention import ATTN_INT_SCALE, int_score_scale
from repro_torch.quant import W4_CLIPS, W4_GROUPS, calibrate_ptq

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4
QWEN = "codeqwen1.5-7b"
# the integer attention's score scale at head_dim 128 and 16
S_128, S_16 = int_score_scale(128), int_score_scale(16)
SCALES = [S_128, S_16, 0.05, 0.3]


@pytest.fixture(autouse=True)
def _interpret():
    set_interpret(True)


def T(a):
    return torch.from_numpy(np.array(a))


def same(port: torch.Tensor, jx) -> bool:
    a, b = port.numpy(), np.asarray(jx)
    return a.shape == b.shape and np.array_equal(a, b)


def spread_rows(rng, m, n):
    """int32 rows: narrow ones (a few q_ln2 wide), wide ones (past
    30*q_ln2 below the max at every scale here) and one saturated entry
    against a floor, as a saturated query row against one aligned key."""
    x = rng.integers(-3000, 3000, (m, n))
    x[1::3] = rng.integers(-2 ** 20, 2 ** 20, (len(x[1::3]), n))
    x[2, :] = -130048
    x[2, 5] = 129032
    return x.astype(np.int32)


# ---------------------------------------------------------------------------
# the integer exp and softmax (core.inumerics)
# ---------------------------------------------------------------------------

class TestIntSoftmaxNumerics:
    @pytest.mark.parametrize("scale", SCALES)
    def test_i_exp_every_shift(self, rng, scale):
        q = -np.concatenate([np.arange(0, 4096), rng.integers(
            0, 2 ** 24, 8192)]).astype(np.int32)
        (a, sa), (b, sb) = jnum.i_exp(q, scale), tnum.i_exp(T(q), scale)
        assert same(b, a) and sa == sb

    @pytest.mark.parametrize("scale", SCALES)
    def test_exp_rescale_shift_and_consts(self, scale):
        assert tnum.exp_rescale_shift(scale) == jnum.exp_rescale_shift(scale)
        assert _exp_consts(scale) == j_exp_consts(scale)
        assert tnum.SOFTMAX_OUT_SCALE == jnum.SOFTMAX_OUT_SCALE

    @pytest.mark.parametrize("scale", SCALES)
    @pytest.mark.parametrize("masked", [False, True])
    def test_i_softmax_int32(self, rng, scale, masked):
        x = spread_rows(rng, 24, 96)
        mask = rng.random(x.shape) > 0.3 if masked else None
        if masked:
            mask[3] = False                          # a wholly masked row
        want = jax.jit(lambda a, m: jnum.i_softmax(a, scale, mask=m))(x, mask)
        got = tnum.i_softmax(T(x), scale,
                             mask=None if mask is None else T(mask))
        assert same(got, want)

    @pytest.mark.parametrize("scale", [0.05, 0.3, 1.0 / 16])
    def test_i_softmax_every_int8_row(self, scale):
        x = np.arange(-128, 128, dtype=np.int32).reshape(4, 64)
        x = np.concatenate([x, x[:, ::-1], np.roll(x, 7, 1)])
        want = jax.jit(lambda a: jnum.i_softmax(a, scale))(x)
        assert same(tnum.i_softmax(T(x), scale), want)


# ---------------------------------------------------------------------------
# int_softmax (B13)
# ---------------------------------------------------------------------------

class TestIntSoftmax:
    @pytest.mark.parametrize("dtype", [np.int32, np.int8])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("scale", [S_128, 0.05])
    def test_exact_vs_jit_ref(self, rng, dtype, masked, scale):
        x = (spread_rows(rng, 16, 80) if dtype == np.int32
             else rng.integers(-128, 128, (16, 80)).astype(np.int8))
        mask = rng.random(x.shape) > 0.25 if masked else None
        want = jax.jit(lambda a, m: ref.int_softmax_ref(a, scale, m))(x, mask)
        got = int_softmax_ref(T(x), scale, None if mask is None else T(mask))
        assert got.dtype == torch.int8 and same(got, want)

    @pytest.mark.parametrize("masked", [False, True])
    def test_exact_vs_pallas_interpret(self, rng, masked):
        x = spread_rows(rng, 16, 128)
        mask = rng.random(x.shape) > 0.25 if masked else None
        want = pallas_softmax(jnp.asarray(x), S_128,
                              None if mask is None else jnp.asarray(mask),
                              bm=8, interpret=True)
        got = ops.softmax_i8(T(x), S_128, None if mask is None else T(mask))
        assert same(got, want)

    def test_ops_lead_dims_and_broadcast_mask(self, rng):
        x = rng.integers(-500, 500, (2, 3, 5, 40)).astype(np.int32)
        mask = np.tril(np.ones((5, 40), bool), 30)
        want = ref.int_softmax_ref(x, 0.05, np.broadcast_to(mask, x.shape))
        got = ops.softmax_i8(T(x), 0.05, T(mask))
        assert same(got, want)


# ---------------------------------------------------------------------------
# int8_flash_attention (B11)
# ---------------------------------------------------------------------------

def attn_inputs(rng, b=2, h=4, hkv=2, s=48, skv=None, d=16, wide=False):
    skv = s if skv is None else skv
    q = rng.integers(-128, 128, (b, h, s, d)).astype(np.int8)
    k = rng.integers(-128, 128, (b, hkv, skv, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, hkv, skv, d)).astype(np.int8)
    if not wide:                       # model-like: |x| ~ 16 at 1/16 scale
        q, k = (np.clip(np.round(rng.standard_normal(a.shape) * 16), -128,
                        127).astype(np.int8) for a in (q, k))
    else:                              # a saturated row and its aligned key
        q[0, 0, 7] = 127
        k[0, 0, 3] = 127
    vs = rng.uniform(1e-3, 5e-2, (b, hkv, skv, 1)).astype(np.float32)
    return q, k, v, vs


def _jax_probs(q, k, scale, causal):
    """The oracle's integer probabilities (``ref.int8_flash_attention_ref``
    up to the PV product)."""
    h, hkv = q.shape[1], k.shape[1]
    k = jnp.repeat(k, h // hkv, axis=1)
    s, skv, d = q.shape[2], k.shape[2], q.shape[3]
    rshift = max(int(round(math.log2(math.sqrt(d)))), 0)
    sc = jnp.einsum("bhsd,bhtd->bhst", q.astype(jnp.int32),
                    k.astype(jnp.int32)) >> rshift
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, skv), bool), k=skv - s), sc,
                       -(2 ** 24))
    return jnum.i_softmax(sc, scale)


class TestInt8FlashAttention:
    @pytest.mark.parametrize("hkv", [4, 2, 1])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("wide", [False, True])
    def test_int32_form_and_probs_exact(self, rng, hkv, causal, wide):
        q, k, v, _ = attn_inputs(rng, hkv=hkv, wide=wide)
        sc = S_16
        want = jax.jit(lambda *a: ref.int8_flash_attention_ref(
            *a, sc, causal))(q, k, v)
        got = int8_flash_attention_ref(T(q), T(k), T(v), sc, causal)
        assert got.dtype == torch.int32 and same(got, want)
        pj = jax.jit(lambda a, b_: _jax_probs(a, b_, sc, causal))(q, k)
        assert same(int8_attention_probs_ref(T(q), T(k), sc, causal), pj)

    @pytest.mark.parametrize("hkv", [4, 1])
    @pytest.mark.parametrize("causal", [True, False])
    def test_v_scale_form_close(self, rng, hkv, causal):
        q, k, v, vs = attn_inputs(rng, hkv=hkv, d=32, s=40)
        sc = int_score_scale(32)
        want = jax.jit(lambda *a: ref.int8_flash_attention_ref(
            *a[:3], sc, causal, v_scale=a[3]))(q, k, v, vs)
        got = int8_flash_attention_ref(T(q), T(k), T(v), sc, causal,
                                       v_scale=T(vs))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)

    def test_non_causal_cross_lengths(self, rng):
        q, k, v, vs = attn_inputs(rng, s=24, skv=56)
        want = ref.int8_flash_attention_ref(q, k, v, S_16, False)
        assert same(int8_flash_attention_ref(T(q), T(k), T(v), S_16, False),
                    want)

    @pytest.mark.parametrize("v_scale", [False, True])
    def test_vs_pallas_interpret(self, rng, v_scale):
        q, k, v, vs = attn_inputs(rng, b=1, s=32)
        want = pallas_int8_attention(
            *map(jnp.asarray, (q, k, v)), S_16, causal=True,
            v_scale=jnp.asarray(vs) if v_scale else None, bq=16, bk=16,
            interpret=True)
        got = ops.attention_i8(T(q), T(k), T(v), S_16, causal=True,
                               v_scale=T(vs) if v_scale else None)
        if v_scale:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
        else:
            assert same(got, want)

    @pytest.mark.parametrize("d,want", [(16, 2), (32, 2), (64, 3), (128, 4)])
    def test_head_shift_is_round_half_even(self, d, want):
        # D = 32: log2(sqrt(32)) = 2.5 rounds to 2 (C's lround gives 3)
        assert head_shift(d) == want

    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    def test_masked_keys_are_skippable_at_the_model_scale(self, d):
        sc = int_score_scale(d)
        want = ATTN_INT_SCALE ** 2 * 2.0 ** head_shift(d) / math.sqrt(d)
        assert sc == want
        assert masked_exp_is_zero(sc, d)
        # and the oracle agrees: a masked score's exp is 0 for the extreme
        # row maxima int8 inputs allow
        smax = (128 * 128 * d) >> head_shift(d)
        for m in (-smax, 0, smax):
            qs = torch.tensor([max(-(2 ** 24) - m, -(2 ** 24))],
                              dtype=torch.int32)
            e, _ = tnum.i_exp(qs, sc)
            assert int(e >> tnum.exp_rescale_shift(sc)) == 0

    @pytest.mark.parametrize("skv,d,fits", [(1024, 128, True),
                                            (1024, 16, True),
                                            (3328, 128, True),
                                            (3329, 128, True)])
    def test_score_block_fits_shared_memory(self, skv, d, fits):
        # the kernel keeps no score block: a ring of 3 stages of a K and a
        # V tile of 64 keys (rows padded to an odd count of 16-byte chunks,
        # K's to whole 32-byte k steps) and 64 V scales, then the
        # dequantized f32 V tile, the f32 probabilities [64][20] of each 16
        # rows and two 32-bit key masks per 8 rows — the same at any key
        # count, past the old form's 3328 too
        dp = -(-d // 32) * 32
        ldv = d + (16 if (d // 16) % 2 == 0 else 0)
        want = 3 * (64 * (dp + 16) + 64 * ldv + 64 * 4) + 64 * d * 4 \
            + 4 * 64 * 20 * 4 + 8 * 2 * 4
        assert block_smem(skv, d) == want == block_smem(64, d)
        assert (block_smem(skv, d) <= SMEM_LIMIT) == fits

    def test_debug_probs_only_on_the_card(self, rng):
        q, k, v, _ = attn_inputs(rng, b=1)
        with pytest.raises(ValueError, match="p_out"):
            int8_flash_attention(T(q), T(k), T(v), S_16,
                                 p_out=torch.empty(1, dtype=torch.int8))


# ---------------------------------------------------------------------------
# flash_attention (B12)
# ---------------------------------------------------------------------------

class TestFlashAttention:
    @pytest.mark.parametrize("hkv", [4, 2])
    @pytest.mark.parametrize("causal", [True, False])
    def test_f32_close_vs_oracle(self, rng, hkv, causal):
        q = rng.standard_normal((2, 4, 40, 16)).astype(np.float32)
        k = rng.standard_normal((2, hkv, 40, 16)).astype(np.float32)
        v = rng.standard_normal((2, hkv, 40, 16)).astype(np.float32)
        want = jax.jit(lambda *a: ref.flash_attention_ref(*a, causal))(q, k, v)
        got = flash_attention_ref(T(q), T(k), T(v), causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    def test_bf16_close_vs_oracle(self, rng):
        q, k, v = (jnp.asarray(rng.standard_normal((1, 4, 64, 32)),
                               jnp.bfloat16) for _ in range(3))
        want = jax.jit(ref.flash_attention_ref)(q, k, v)
        tq, tk, tv = (T(np.asarray(a.astype(jnp.float32))).bfloat16()
                      for a in (q, k, v))
        got = ops.attention(tq, tk, tv)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=FA_RTOL, atol=FA_ATOL)


def bf16_qkv(rng, b, h, hkv, s, d):
    """bf16 q [B,H,S,D], k/v [B,Hkv,S,D] as numpy f32 (exact in bf16) and
    as torch bf16."""
    arrs = [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                       .astype(jnp.float32))
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    return arrs, [T(a).bfloat16() for a in arrs]


def within_tol(got: torch.Tensor, want) -> bool:
    want = torch.as_tensor(np.asarray(want, dtype=np.float32))
    return bool(((got.float() - want).abs()
                 <= FA_ATOL + FA_RTOL * want.abs()).all())


class TestFlashAttentionKernelOrder:
    """``flash_attention_tiled_ref``, the CUDA kernel's order (64-key tiles,
    an online softmax, P split into bf16 hi + lo before P@V), within the
    unchanged RTOL/ATOL of the plain version and of the Pallas kernel in
    interpret mode: the kernel's rounding fits the tolerance."""

    @pytest.mark.parametrize("d", [16, 80, 128])
    @pytest.mark.parametrize("causal", [True, False])
    def test_close_to_plain_and_pallas(self, rng, d, causal):
        (q, k, v), (tq, tk, tv) = bf16_qkv(rng, 1, 4, 1, 160, d)
        got = flash_attention_tiled_ref(tq, tk, tv, causal)
        assert got.dtype == torch.bfloat16
        assert within_tol(got, flash_attention_ref(tq, tk, tv, causal).float())
        want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            causal=causal, bq=32, bk=32, interpret=True)
        assert within_tol(got, want.astype(jnp.float32))

    def test_long_sequence(self, rng):
        """T = 1024 (16 key tiles, the no-cache forward's length), H = 2."""
        (q, k, v), (tq, tk, tv) = bf16_qkv(rng, 1, 2, 2, 1024, 128)
        got = flash_attention_tiled_ref(tq, tk, tv)
        assert within_tol(got, flash_attention_ref(tq, tk, tv).float())
        want = pallas_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            bq=128, bk=128, interpret=True)
        assert within_tol(got, want.astype(jnp.float32))

    def test_one_bf16_term_misses_the_tolerance(self, rng):
        """Why the kernel splits P: one bf16 rounding of P before P@V leaves
        early causal rows (one probability carrying the row) outside
        RTOL/ATOL; hi + lo stays inside."""
        _, (tq, tk, tv) = bf16_qkv(rng, 1, 8, 8, 256, 128)
        plain = flash_attention_ref(tq, tk, tv).float()
        assert not within_tol(flash_attention_tiled_ref(tq, tk, tv,
                                                        split=False), plain)
        assert within_tol(flash_attention_tiled_ref(tq, tk, tv), plain)


# ---------------------------------------------------------------------------
# any head dim that is a multiple of 16 up to 128 (B11, B12; ROADMAP C7)
# ---------------------------------------------------------------------------

class TestHeadDims:
    @pytest.mark.parametrize("d", [64, 80])
    @pytest.mark.parametrize("v_scale", [False, True])
    def test_int8_vs_pallas_interpret(self, rng, d, v_scale):
        q, k, v, vs = attn_inputs(rng, b=1, s=48, d=d)
        sc = int_score_scale(d)
        want = pallas_int8_attention(
            *map(jnp.asarray, (q, k, v)), sc, causal=True,
            v_scale=jnp.asarray(vs) if v_scale else None, bq=16, bk=16,
            interpret=True)
        got = ops.attention_i8(T(q), T(k), T(v), sc, causal=True,
                               v_scale=T(vs) if v_scale else None)
        if v_scale:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
        else:
            assert same(got, want)

    @pytest.mark.parametrize("d", [64, 80])
    def test_int8_probs_exact_vs_jit_oracle(self, rng, d):
        q, k, v, _ = attn_inputs(rng, h=4, hkv=2, s=40, d=d, wide=True)
        sc = int_score_scale(d)
        want = jax.jit(lambda *a: ref.int8_flash_attention_ref(
            *a, sc, True))(q, k, v)
        assert same(int8_flash_attention_ref(T(q), T(k), T(v), sc), want)
        pj = jax.jit(lambda a, b_: _jax_probs(a, b_, sc, True))(q, k)
        assert same(int8_attention_probs_ref(T(q), T(k), sc), pj)

    @pytest.mark.parametrize("d", [64, 80])
    def test_flash_vs_oracle(self, rng, d):
        q = rng.standard_normal((1, 4, 40, d)).astype(np.float32)
        k, v = (rng.standard_normal((1, 2, 40, d)).astype(np.float32)
                for _ in range(2))
        want = jax.jit(ref.flash_attention_ref)(q, k, v)
        got = flash_attention_ref(T(q), T(k), T(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    @pytest.mark.parametrize("d,shift", [(48, 3), (80, 3), (96, 3),
                                         (112, 3)])
    def test_new_dims_shift_and_masked_exp(self, d, shift):
        """zamba2's 80 (2560 / 32 heads) and the other new widths: the
        score shift and the skippable masked exp at the model's scale."""
        assert head_shift(d) == shift
        assert masked_exp_is_zero(int_score_scale(d), d)

    def test_block_form_at_80(self):
        """zamba2's forward (T = 1024) and a 4096-key sequence take the
        kernel's one form, whose block at head dim 80 pads K rows to three
        32-byte k steps (96 + 16 bytes) and keeps V rows at 80 bytes (an
        odd count of 16-byte chunks)."""
        assert block_smem(1024, 80) == block_smem(4096, 80) <= SMEM_LIMIT
        assert (block_smem(1024, 80)
                == 3 * (64 * 112 + 64 * 80 + 64 * 4) + 64 * 80 * 4
                + 4 * 64 * 20 * 4 + 8 * 2 * 4)

    @pytest.mark.parametrize("d,ok", [(16, True), (64, True), (80, True),
                                      (128, True), (8, False), (72, False),
                                      (144, False)])
    def test_wrappers_take_multiples_of_16(self, monkeypatch, d, ok):
        """On the card a head dim the kernels take reaches the build (here
        it raises); any other raises the wrapper's check, never a
        fallback."""
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import int8_flash_attention as ia

        def no_build(*a, **k):
            raise RuntimeError("no nvcc here")
        monkeypatch.setattr(build, "entry", no_build)
        for mod in (fa, ia):
            monkeypatch.setattr(mod, "on_cuda", lambda *a: True)
        i8 = torch.zeros((1, 2, 16, d), dtype=torch.int8)
        bf = torch.zeros((1, 2, 16, d), dtype=torch.bfloat16)
        for call in (lambda: ops.attention(bf, bf, bf),
                     lambda: ops.attention_i8(i8, i8, i8,
                                              int_score_scale(max(d, 16)))):
            with pytest.raises(RuntimeError if ok else ValueError,
                               match="no nvcc" if ok else "head_dim"):
                call()


# ---------------------------------------------------------------------------
# lm_loss and calibrate_ptq at reduced codeqwen1.5-7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_float():
    cfg = jget_config(QWEN, precision="bf16", reduced=True)
    p = jinit_params(jax.random.PRNGKey(0), cfg)
    return p, jax.device_get(p)


def _tokens(cfg, b, t, seed=3):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("prec", ["bf16", "w8a8", "w4a8"])
def test_lm_loss_vs_reference(qwen_float, prec):
    from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4
    from repro_torch.quant import quantize_for
    jp, tree = qwen_float
    jcfg = jget_config(QWEN, precision=prec, reduced=True)
    cfg = get_config(QWEN, precision=prec, reduced=True)
    toks = _tokens(cfg, 2, 17)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1                                 # masked positions
    if prec != "bf16":
        jp = jptq(jp, policy=J_W4 if prec == "w4a8" else None)
    want = float(jax.jit(lambda p, t, l: jlm_loss(p, jcfg, t, l))(
        jp, toks[:, :-1], labels))
    tp = quantize_for(from_reference(tree, cfg, device="cpu"), prec)
    got = float(lm_loss(tp, cfg, T(toks[:, :-1]).long(), T(labels).long()))
    assert math.isfinite(got) and got == pytest.approx(want, rel=LOSS_RTOL)


def test_calibrate_ptq_matches_reference(qwen_float):
    jp, tree = qwen_float
    jcfg = jget_config(QWEN, precision="w8a8", reduced=True)
    cfg = get_config(QWEN, precision="w8a8", reduced=True)
    toks = _tokens(cfg, 2, 16, seed=5)
    fwd = jax.jit(lambda p: jforward(p, jcfg, toks)[0])
    jpolicy, jreport = jcalibrate(jp, fwd)
    model = from_reference(tree, cfg, device="cpu")
    policy, report = calibrate_ptq(
        model, lambda m: forward(m, cfg, T(toks).long())[0])
    assert policy == jpolicy
    assert model.layers[0].attn.wq.weight is not None   # left float
    for cls in ("attn", "mlp"):
        ours, theirs = report[cls]["scores"], jreport[cls]["scores"]
        assert [(s["group"], s["clip"]) for s in ours] == [
            (g, c) for g in W4_GROUPS for c in W4_CLIPS]
        rank = sorted(range(len(ours)), key=lambda i: ours[i]["mse"])
        jrank = sorted(range(len(theirs)), key=lambda i: theirs[i]["mse"])
        assert rank == jrank
        assert report[cls]["demoted_to_int8"] == jreport[cls]["demoted_to_int8"]
        np.testing.assert_allclose([s["mse"] for s in ours],
                                   [s["mse"] for s in theirs], rtol=0.05)


def test_calibrate_ptq_demotes_past_the_bound(qwen_float):
    _, tree = qwen_float
    cfg = get_config(QWEN, precision="w8a8", reduced=True)
    toks = T(_tokens(cfg, 1, 8)).long()
    policy, report = calibrate_ptq(
        from_reference(tree, cfg, device="cpu"),
        lambda m: forward(m, cfg, toks)[0], groups=(64,), clips=(1.0,),
        max_rel_mse=0.0)
    assert policy == {"head": "int8", "attn": "int8", "mlp": "int8"}
    assert all(report[c]["demoted_to_int8"] for c in ("attn", "mlp"))


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
class TestNoCacheKernelsOnCard:
    @pytest.mark.parametrize("masked", [False, True])
    def test_int_softmax(self, rng, cuda_dev, masked):
        x = T(spread_rows(rng, 64, 1024)).to(cuda_dev)
        mask = (T(rng.random((64, 1024)) > 0.3).to(cuda_dev) if masked
                else None)
        assert torch.equal(ops.softmax_i8(x, S_128, mask),
                           int_softmax_ref(x, S_128, mask))

    @pytest.mark.parametrize("hkv", [8, 1])
    def test_int8_flash_attention(self, rng, cuda_dev, hkv):
        q, k, v, vs = (T(a).to(cuda_dev) for a in attn_inputs(
            rng, b=1, h=8, hkv=hkv, s=300, d=128, wide=True))
        p_out = torch.empty((1, 8, 300, 300), dtype=torch.int8,
                            device=cuda_dev)
        got = int8_flash_attention(q, k, v, S_128, v_scale=vs, p_out=p_out)
        want = int8_flash_attention_ref(q, k, v, S_128, v_scale=vs)
        assert torch.equal(p_out.int(), int8_attention_probs_ref(q, k, S_128))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(int8_flash_attention(q, k, v, S_128),
                           int8_flash_attention_ref(q, k, v, S_128))

    def test_flash_attention(self, rng, cuda_dev):
        q, k, v = (T(rng.standard_normal((1, 8, 200, 128)).astype(
            np.float32)).to(cuda_dev).bfloat16() for _ in range(3))
        torch.testing.assert_close(ops.attention(q, k, v).float(),
                                   flash_attention_ref(q, k, v).float(),
                                   rtol=FA_RTOL, atol=FA_ATOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_flash_attention_d80(self, rng, cuda_dev, causal):
        """zamba2-2.7b's head dim on the tensor-core kernel: GQA 4:1, a
        ragged last query block and key tile."""
        _, qkv = bf16_qkv(rng, 2, 8, 2, 300, 80)
        q, k, v = (a.to(cuda_dev) for a in qkv)
        torch.testing.assert_close(
            ops.attention(q, k, v, causal=causal).float(),
            flash_attention_ref(q, k, v, causal).float(),
            rtol=FA_RTOL, atol=FA_ATOL)

    @pytest.mark.parametrize("d", [48, 64, 80, 112])
    def test_any_head_dim(self, rng, cuda_dev, d):
        q, k, v, vs = (T(a).to(cuda_dev) for a in attn_inputs(
            rng, b=1, h=4, hkv=2, s=300, d=d, wide=True))
        sc = int_score_scale(d)
        torch.testing.assert_close(
            int8_flash_attention(q, k, v, sc, v_scale=vs),
            int8_flash_attention_ref(q, k, v, sc, v_scale=vs),
            rtol=RTOL, atol=ATOL)
        assert torch.equal(int8_flash_attention(q, k, v, sc),
                           int8_flash_attention_ref(q, k, v, sc))
        qb, kb, vb = (x.float().bfloat16() for x in (q, k, v))
        torch.testing.assert_close(ops.attention(qb, kb, vb).float(),
                                   flash_attention_ref(qb, kb, vb).float(),
                                   rtol=FA_RTOL, atol=FA_ATOL)
