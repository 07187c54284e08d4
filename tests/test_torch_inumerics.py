"""The port's integer numerics (``repro_torch.core.inumerics``) against the
JAX reference (``repro.core.inumerics``): bit-exact on every int8 input and
on random int32 (int16 for the SiLU), for the requant, exp/sigmoid/SiLU,
GELU and integer-sqrt/LayerNorm subset the ported kernels rest on."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:            # container image has no hypothesis
    from _hypothesis_compat import given, settings, st

from repro.core import inumerics as jnum
from repro.kernels.common import requant_block as j_requant_block
from repro.kernels.int_gelu import gelu_block as j_gelu_block
from repro.kernels.int_gelu import gelu_requant_params as j_gelu_params
from repro.kernels.int_silu import silu_block as j_silu_block
from repro.kernels.int_silu import silu_out_scale as j_silu_out_scale

from repro_torch.core import inumerics as tnum
from repro_torch.kernels.common import requant_block
from repro_torch.kernels.int_gelu import (gelu_block, gelu_consts,
                                          gelu_requant_params, int_gelu_ref)
from repro_torch.kernels.int_silu import (int_silu_ref, silu_block,
                                          silu_consts, silu_out_scale)
from repro_torch.models.layers import SILU_INT_SCALE

INT8 = np.arange(-128, 128, dtype=np.int32)
MULTS = [(1e-4, 127 * 127 * 64), (3.1e-3, 127 * 127 * 3072), (0.07, 2 ** 20),
         (0.9, 300), (1.7, 2 ** 15), (12.0, 1000)]


def T(a):
    return torch.from_numpy(np.array(a))


def same(port: torch.Tensor, jx) -> bool:
    return np.array_equal(port.numpy(), np.asarray(jx))


@pytest.mark.parametrize("mult,bound", MULTS)
def test_compute_requant_params_identical(mult, bound):
    a, b = jnum.compute_requant_params(mult, bound), \
        tnum.compute_requant_params(mult, bound)
    assert (a.s1, a.mult, a.s2) == (b.s1, b.mult, b.s2)


@pytest.mark.parametrize("s", range(0, 12))
def test_rshift_round(rng, s):
    x = np.concatenate([INT8, rng.integers(-2 ** 24, 2 ** 24, 4096)]).astype(np.int32)
    assert same(tnum.rshift_round(T(x), s), jnum.rshift_round(x, s))


@pytest.mark.parametrize("mult,bound", MULTS)
def test_requantize_every_int8_and_random_int32(rng, mult, bound):
    p = jnum.compute_requant_params(mult, bound)
    x = np.concatenate([INT8, rng.integers(-bound, bound + 1, 8192)]).astype(np.int32)
    want = jax.jit(lambda v: jnum.requantize(v, p))(x)
    got = tnum.requantize(T(x), tnum.RequantParams(p.s1, p.mult, p.s2))
    assert same(got, want)
    # the kernels' in-register form agrees with both
    assert same(requant_block(T(x), p.s1, p.mult, p.s2),
                j_requant_block(jnp.asarray(x), p.s1, p.mult, p.s2))


@pytest.mark.parametrize("scale", [8.0 / 127.0, 0.02, 0.2])
def test_gelu_every_int8(scale):
    q_j, s_j = jnum.i_gelu_int8(INT8, scale)
    q_t, s_t = tnum.i_gelu_int8(T(INT8), scale)
    assert same(q_t, q_j) and s_t == s_j
    p = j_gelu_params(scale)
    assert (p.s1, p.mult, p.s2) == tuple(vars(gelu_requant_params(scale)).values())
    assert same(gelu_block(T(INT8), scale=scale, s1=p.s1, mult=p.mult, s2=p.s2),
                j_gelu_block(jnp.asarray(INT8), scale=scale, s1=p.s1,
                             mult=p.mult, s2=p.s2))
    assert same(int_gelu_ref(T(INT8), scale).to(torch.int32), q_j)
    assert gelu_consts(scale)[3:] == (p.s1, p.mult, p.s2)


SILU_SCALES = [SILU_INT_SCALE, 0.02, 0.2]


def _silu_inputs(rng):
    """every int8, then random int16 (the i_silu exactness range)."""
    return np.concatenate([INT8, rng.integers(-2 ** 15, 2 ** 15, 8192)]
                          ).astype(np.int32)


@pytest.mark.parametrize("scale", SILU_SCALES)
def test_exp_every_int8_and_random_int16(rng, scale):
    q = -np.abs(_silu_inputs(rng))                  # i_exp takes q <= 0
    want, s_j = jax.jit(lambda v: jnum.i_exp(v, scale))(q)
    got, s_t = tnum.i_exp(T(q), scale)
    assert same(got, want) and s_t == jnum.i_exp(q[:1], scale)[1]


@pytest.mark.parametrize("scale", SILU_SCALES)
def test_sigmoid_every_int8_and_random_int16(rng, scale):
    q = _silu_inputs(rng)
    assert same(tnum.i_sigmoid(T(q), scale),
                jax.jit(lambda v: jnum.i_sigmoid(v, scale))(q))


@pytest.mark.parametrize("scale", SILU_SCALES)
def test_silu_every_int8_and_random_int16(rng, scale):
    q = _silu_inputs(rng)
    want, s_j = jax.jit(lambda v: jnum.i_silu(v, scale))(q)
    got, s_t = tnum.i_silu(T(q), scale)
    assert same(got, want) and s_t == jnum.i_silu(q[:1], scale)[1]
    # the fused epilogues' in-register form and the plain int_silu_ref
    assert same(silu_block(T(q), scale=scale),
                j_silu_block(jnp.asarray(q), scale=scale))
    assert same(int_silu_ref(T(q), scale), want)
    assert silu_out_scale(scale) == j_silu_out_scale(scale)


@pytest.mark.parametrize("scale", SILU_SCALES)
def test_silu_consts_are_the_reference_constants(scale):
    q_ln2, q_b, q_c, q_one = silu_consts(scale)
    # a single value exercises each constant: i_exp(0) = q_b^2 + q_c, and
    # i_sigmoid(0) = round(127 * q_one / (q_one + q_b^2 + q_c))
    e0 = int(jnum.i_exp(jnp.zeros(1, jnp.int32), scale)[0][0])
    assert e0 == q_b * q_b + q_c
    assert q_ln2 == max(int(np.floor(np.log(2.0) / scale)), 1)
    sig0 = int(jnum.i_sigmoid(jnp.zeros(1, jnp.int32), scale)[0])
    assert sig0 == (q_one * 127 + (q_one + e0) // 2) // (q_one + e0)


def test_isqrt_dense_range_and_random(rng):
    n = np.concatenate([np.arange(0, 70000),
                        rng.integers(0, 2 ** 24, 20000)]).astype(np.int32)
    got = tnum.i_sqrt(T(n))
    assert same(got, jax.jit(jnum.i_sqrt)(n))
    ref = np.floor(np.sqrt(n.astype(np.float64))).astype(np.int32)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("d", [16, 64, 3072, 40000])
def test_layernorm(rng, rms, d):
    x = rng.integers(-128, 128, (4, d)).astype(np.int32)
    x[1] -= 100
    g = rng.integers(-128, 128, d).astype(np.int32)
    b = rng.integers(-128, 128, d).astype(np.int32)
    f = jax.jit(lambda *a: jnum.i_layernorm(a[0], 1.0, a[1], a[2], 1.0,
                                            rms_only=rms)[0])
    got, scale = tnum.i_layernorm(T(x), 1.0, T(g), T(b), 1.0, rms_only=rms)
    assert same(got, f(x, g, b)) and scale == 1.0 / 128


@settings(deadline=None, max_examples=25)
@given(mult=st.floats(min_value=1e-5, max_value=20.0),
       log_bound=st.integers(min_value=4, max_value=30),
       seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_requantize_property(mult, log_bound, seed):
    bound = 2 ** log_bound
    p = jnum.compute_requant_params(mult, bound)
    x = np.random.default_rng(seed).integers(-bound, bound, 512).astype(np.int32)
    got = tnum.requantize(T(x), tnum.compute_requant_params(mult, bound))
    assert same(got, jnum.requantize(x, p))
