"""The port's threefry streams (``repro_torch.serve.prng``) against
``jax.random`` as jax 0.9.0 runs it (``jax_threefry_partitionable`` on, no
64-bit types), on the CPU.

Exact: ``PRNGKey``, ``fold_in`` (the reserved warmup range at the top of
uint32 too, vmapped over lanes as the engine folds them), the 32-bit random
bits and the f32 uniforms, bit for bit over seeds and shapes.  ``gumbel`` is
``-log(-log(u))`` on those exact uniforms; each ``log`` is the device's and
lies within ``LOG_ULP`` (1) ulp of XLA:CPU's, an ulp taken at
max(|log|, 1): near x = 1 the results are tiny, and there torch's
vectorized and scalar loops (which elements take which depends on the
buffer's alignment) and XLA's differ by up to ~1e-8, many ulps of such a
result.  A Gumbel value then lies within ``GUMBEL_ATOL`` (1e-6 absolute: the
values are O(1) to ~16, and near 0 a 1-ulp step of the inner log moves them
by ~5e-7).  ``categorical`` then
equals the reference's wherever the perturbed top-2 margin is above
``2 * GUMBEL_ATOL``.  The engine's sampler (``_sample``) divides by the
temperature truly, as the reference's eager ``_sample`` does, and draws the
reference's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.serve.engine import _sample as jsample

from repro_torch.serve import prng
from repro_torch.serve.engine import _sample

LOG_ULP = 1
GUMBEL_ATOL = 1e-6
SEEDS = (0, 1, 3, 12345, 2 ** 31 - 1, -1, -7)


def words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def bits_of(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(words(jax.random.PRNGKey(seed)),
                          prng.prng_key(seed).numpy())


@pytest.mark.parametrize("data", [0, 1, 2, 7, 12345, 2 ** 31, 2 ** 32 - 2,
                                  2 ** 32 - 1 - 256, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", (0, 5))
def test_fold_in(seed, data):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(words(jax.random.fold_in(k, data)),
                          prng.fold_in(prng.prng_key(seed), data).numpy())


def test_fold_in_vmapped_like_the_engine():
    """(B, 2) lane keys folded at (B,) positions, as ``_keys_at`` does."""
    base = jax.random.PRNGKey(3)
    lanes = jnp.stack([jax.random.fold_in(base, s) for s in (0, 5, 9, 2 ** 32 - 2)])
    pos = np.array([0, 17, 1023, 4], np.int32)
    want = jax.vmap(jax.random.fold_in)(lanes, jnp.asarray(pos))
    tl = prng.fold_in(prng.prng_key(3).expand(4, 2),
                      torch.tensor([0, 5, 9, 2 ** 32 - 2]))
    assert np.array_equal(words(lanes), tl.numpy())
    got = prng.fold_in(tl, torch.from_numpy(pos.astype(np.int64)))
    assert np.array_equal(words(want), got.numpy())


SHAPES = [(1,), (2,), (5,), (7, 3), (4, 4, 2), (1000,), (92416,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    tk = prng.fold_in(prng.prng_key(11), 4)
    assert np.array_equal(
        words(jax.random.bits(k, shape, dtype=jnp.uint32)),
        prng.random_bits(tk, shape).numpy())
    assert np.array_equal(bits_of(jax.random.uniform(k, shape)),
                          bits_of(prng.uniform(tk, shape).numpy()))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    assert np.array_equal(
        bits_of(jax.random.uniform(k, shape, minval=tiny, maxval=1.0)),
        bits_of(prng.uniform(tk, shape, prng.F32_TINY, 1.0).numpy()))


@settings(max_examples=25, deadline=None)
@given(st.integers(-2 ** 31, 2 ** 31 - 1), st.integers(0, 2 ** 32 - 1),
       st.integers(1, 300))
def test_bits_and_uniforms_property(seed, data, n):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = prng.fold_in(prng.prng_key(seed), data)
    assert np.array_equal(words(k), tk.numpy())
    assert np.array_equal(words(jax.random.bits(k, (n,), dtype=jnp.uint32)),
                          prng.random_bits(tk, (n,)).numpy())
    assert np.array_equal(bits_of(jax.random.uniform(k, (n,))),
                          bits_of(prng.uniform(tk, (n,)).numpy()))


@pytest.mark.parametrize("seed", (0, 9))
def test_gumbel(seed):
    """Exact uniforms; each log within ``LOG_ULP`` ulps (at max(|log|, 1))
    of XLA:CPU's; the Gumbel values within ``GUMBEL_ATOL``."""
    shape = (20000,)
    k = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u = np.asarray(jax.random.uniform(k, shape, minval=tiny, maxval=1.0))
    inner_j = np.asarray(jnp.log(u))
    inner_t = torch.log(torch.from_numpy(u.copy())).numpy()
    outer_j = np.asarray(jnp.log(-inner_j))
    outer_t = torch.log(torch.from_numpy(-inner_j)).numpy()
    for a, b in ((inner_j, inner_t), (outer_j, outer_t)):
        ulp = np.spacing(np.maximum(np.abs(a), np.float32(1)))
        assert (np.abs(a - b) <= LOG_ULP * ulp).all()
    g_j = np.asarray(jax.random.gumbel(k, shape))
    g_t = prng.gumbel(tk, shape).numpy()
    assert np.abs(g_j - g_t).max() <= GUMBEL_ATOL


@pytest.mark.parametrize("vocab,scale", [(64, 1.0), (5000, 3.0),
                                         (92416, 0.5)])
def test_categorical_where_the_margin_is_clear(vocab, scale):
    rng = np.random.default_rng(vocab)
    lanes = 6
    lg = (rng.standard_normal((lanes, vocab)) * scale).astype(np.float32)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(2), i)
                      for i in range(lanes)])
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, lg))
    tk = prng.fold_in(prng.prng_key(2).expand(lanes, 2), torch.arange(lanes))
    got = prng.categorical(tk, torch.from_numpy(lg)).numpy()
    pert = lg + np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (vocab,)))(keys))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * GUMBEL_ATOL
    assert clear.sum() >= lanes - 1
    assert np.array_equal(want[clear], got[clear])


def test_temperature_is_a_true_division():
    """The reference's ``_sample`` runs eagerly: ``l / 0.7`` under vmap is
    the true f32 division (not C1's reciprocal product), and so is the
    port's division by a 0-dim tensor."""
    rng = np.random.default_rng(0)
    lg = (rng.standard_normal((4, 4096)) * 8).astype(np.float32)
    keys = jnp.zeros((4, 2), jnp.uint32)
    ref = np.asarray(jax.vmap(lambda k, l: l / 0.7)(keys, lg))
    true_div = lg / np.float32(0.7)
    rcp = lg * (np.float32(1.0) / np.float32(0.7))
    assert np.array_equal(ref, true_div)
    assert not np.array_equal(true_div, rcp)    # the two do differ here
    port = (torch.from_numpy(lg) / torch.tensor(0.7, dtype=torch.float32))
    assert np.array_equal(port.numpy(), true_div)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sampler_matches_the_reference(temperature):
    """``_sample`` on (B, V) logits with per-lane keys: the reference's
    tokens (greedy exactly; sampled where the perturbed margin is clear)."""
    rng = np.random.default_rng(5)
    lanes, vocab = 8, 3000
    lg = (rng.standard_normal((lanes, vocab)) * 2).astype(np.float32)
    seqs = np.array([0, 1, 2, 3, 9, 2 ** 32 - 2, 2 ** 32 - 3, 40], np.uint32)
    pos = np.arange(lanes, dtype=np.int32) * 7
    base = jax.random.PRNGKey(4)
    jl = jnp.stack([jax.random.fold_in(base, int(s)) for s in seqs])
    jk = jax.vmap(jax.random.fold_in)(jl, jnp.asarray(pos))
    want = np.asarray(jsample(jnp.asarray(lg), temperature, jk))
    tl = prng.fold_in(prng.prng_key(4).expand(lanes, 2),
                      torch.from_numpy(seqs.astype(np.int64)))
    tk = prng.fold_in(tl, torch.from_numpy(pos.astype(np.int64)))
    got = _sample(torch.from_numpy(lg), temperature, tk).numpy()
    if temperature <= 0:
        assert np.array_equal(want, got)
        return
    pert = lg / np.float32(temperature) + np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (vocab,)))(jk))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * GUMBEL_ATOL
    assert clear.sum() >= lanes - 1
    assert np.array_equal(want[clear], got[clear])
