"""Host-side rules of the redesigned int8_flash_attention (B11) and ssd_scan
(B16) kernels, on the CPU:

* the exact reciprocals that replace the softmax's two integer divisions
  (``common.rcp``, shared with int_softmax: q_ln2's from the wrapper, the
  exp-sum's per row in the kernel) against Python's floor division, over
  the edges and a seeded sample of the ranges the wrapper admits, and the
  kernel's softmax
  arithmetic in that form against the JAX reference's ``i_softmax``;
* the wrappers' choices: one streaming form at every key count, a block's
  shared memory independent of the keys, the range checks, the constants
  the C entry receives, ssd_scan's scratch sizes;
* the chunk-parallel decomposition the four ssd_scan kernels run, written
  out in f64, against the plain version and the JAX reference;
* no fallback: a CUDA tensor reaches the build (here it raises), never the
  plain version.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import inumerics as jnum
from repro.models.ssm import _ssd_chunked as j_ssd_chunked

from repro_torch.kernels import build, ops
from repro_torch.kernels import int8_flash_attention as ifa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.common import LAUNCHES, rcp
from repro_torch.kernels.int_softmax import NEG_INF, _exp_consts
from repro_torch.models.attention import int_score_scale

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
# the integer attention's score scales at every head dim the kernel takes,
# and the coarser scales the reference's softmax tests use
SCALES = sorted({int_score_scale(d) for d in HEAD_DIMS} | {0.05, 0.3})


def _fake_card(monkeypatch, module, seen):
    """Take the module's tensors for CUDA ones and record the C entry's
    arguments instead of launching."""
    def entry(name, symbol, argtypes):
        def fn(*args):
            seen["argtypes"], seen["args"] = argtypes, args
            return 0
        return fn
    monkeypatch.setattr(module, "on_cuda", lambda *a: True)
    monkeypatch.setattr(build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a:
                        types.SimpleNamespace(cuda_stream=0))


def _no_build(monkeypatch):
    def no_build(*a, **k):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)


# ---------------------------------------------------------------------------
# the exact reciprocals
# ---------------------------------------------------------------------------

def _divisors():
    ds = {1, 2, 3, 5, 7, 127, 128, 129, 255, 256, 257, 1000, 12345,
          2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 2 ** 30 - 1, 2 ** 30,
          2 ** 30 + 1, 2 ** 31 - 1}
    ds |= {_exp_consts(s)[0] for s in SCALES}            # every q_ln2
    ds |= {2 ** k + e for k in range(2, 31) for e in (-1, 1)}
    return sorted(d for d in ds if 1 <= d < 2 ** 31)


def _check_rcp(d, n):
    m, sh = rcp(d)
    assert 0 < m < 2 ** 32 and 31 <= sh <= 62
    n = np.asarray(n, dtype=np.uint64)
    got = (n * np.uint64(m)) >> np.uint64(sh)
    want = n // np.uint64(d)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (d, int(n[bad[0]]))


@pytest.mark.parametrize("d", _divisors())
def test_rcp_matches_floor_division_at_the_edges(d):
    top = 2 ** 31 - 1
    n = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, top, top - 1,
         top - top % d, top - top % d - 1, 2 ** 24, 2 ** 24 - 1]
    n += [k * d + e for k in (3, 1000, top // d) for e in (-1, 0, 1)]
    _check_rcp(d, [v for v in n if 0 <= v <= top])
    m, sh = rcp(d)
    for v in (0, d - 1, d, top):                 # in Python's integers too
        assert (v * m) >> sh == v // d


@pytest.mark.parametrize("seed", range(4))
def test_rcp_matches_floor_division_on_a_seeded_sample(seed):
    rng = np.random.default_rng(seed)
    for d in rng.integers(1, 2 ** 31, 64).tolist() + _divisors():
        _check_rcp(int(d), rng.integers(0, 2 ** 31, 4096))


def test_rcp_refuses_divisors_out_of_range():
    for d in (0, -3, 2 ** 31):
        with pytest.raises(ValueError, match="rcp"):
            rcp(d)


def _kernel_softmax(scores: np.ndarray, valid: np.ndarray, scale: float):
    """The kernel's softmax on int score rows, in its order: the row max
    over unmasked keys, exps from the multiply-high halving count, the
    int32 row sum, then probabilities by the row's reciprocal."""
    q_ln2, q_b, q_c, es = _exp_consts(scale)
    ln2_m, ln2_sh = rcp(q_ln2)
    out = np.zeros(scores.shape, dtype=np.int64)
    for r in range(scores.shape[0]):
        keys = np.nonzero(valid[r])[0]
        if keys.size == 0:
            continue
        s = scores[r, keys].astype(np.int64)
        qs = np.maximum(s - s.max(), NEG_INF)
        z = ((-qs) * ln2_m) >> ln2_sh
        t = qs + z * q_ln2 + q_b
        e = ((t * t + q_c) >> np.minimum(z, 30)) >> es
        l_ = max(int(e.sum()), 1)
        assert l_ < 2 ** 31
        lm, lsh = rcp(l_)
        out[r, keys] = np.minimum(((e * 127 + (l_ >> 1)) * lm) >> lsh, 127)
    return out


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_softmax_order_matches_the_reference(scale, causal):
    """Random integer scores (spread far past 30*q_ln2 in some rows):
    the kernel's division-free softmax gives the JAX reference's
    ``i_softmax`` bits."""
    rng = np.random.default_rng(int(scale * 1e6) + causal)
    n = 300
    sc = rng.integers(-4000, 4000, (48, n)).astype(np.int32)
    sc[::5] = rng.integers(-2 ** 20, 2 ** 20, (sc[::5].shape)).astype(np.int32)
    sc[3, 7] = 129032
    valid = (np.tril(np.ones((48, n), dtype=bool), n - 48) if causal
             else np.ones((48, n), dtype=bool))
    want = np.asarray(jax.jit(lambda x, m: jnum.i_softmax(x, scale, mask=m))(
        jnp.asarray(sc), jnp.asarray(valid)))
    got = _kernel_softmax(sc, valid, scale)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", SCALES)
def test_sums_fit_up_to_2_17_keys(scale):
    """Every exp is below 2^15 at the scales used, so 2^17 keys keep the row
    sum and the probability's numerator below 2^31, the reciprocals'
    range; past 2^31 / max exp keys the wrapper refuses."""
    e = ifa.exp_max(scale)
    assert 0 < e < 2 ** 15
    assert ifa.sums_fit(2 ** 17, scale)
    assert not ifa.sums_fit(2 ** 31 // e + 1, scale)


def test_wrapper_refuses_sums_past_the_reciprocals(monkeypatch):
    seen = {}
    _fake_card(monkeypatch, ifa, seen)
    sc = int_score_scale(16)
    skv = 2 ** 31 // ifa.exp_max(sc) + 1
    q = torch.zeros((1, 1, 1, 16), dtype=torch.int8)
    k = torch.zeros((1, 1, 1, 16), dtype=torch.int8).expand(1, 1, skv, 16)
    with pytest.raises(ValueError, match="exact reciprocals"):
        ifa.int8_flash_attention(q, k, k, sc, causal=False)
    assert "args" not in seen


# ---------------------------------------------------------------------------
# int8_flash_attention: one form, its block, its C entry's constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
def test_block_fits_two_an_sm_at_every_head_dim(d):
    """The block's shared memory does not depend on the keys; with
    v_scale two blocks fit an SM's 228 KB (1 KB reserved a block), the
    int32 form takes the ring alone."""
    vs = ifa.block_smem(1024, d)
    assert vs == ifa.block_smem(1, d) == ifa.block_smem(2 ** 17, d)
    assert 2 * (vs + 1024) <= 228 * 1024
    assert ifa.block_smem(1024, d, v_scale=False) < vs
    assert all(ifa.streams(skv, d) for skv in (1, 1024, 3329, 2 ** 17))
    assert not ifa.streams(0, d)


@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("v_scale", [True, False])
def test_entry_receives_q_ln2s_reciprocal(monkeypatch, d, v_scale):
    seen = {}
    _fake_card(monkeypatch, ifa, seen)
    sc = int_score_scale(d)
    q = torch.zeros((2, 4, 40, d), dtype=torch.int8)
    kv = torch.zeros((2, 2, 40, d), dtype=torch.int8)
    vs = torch.ones((2, 2, 40, 1)) if v_scale else None
    ops.reset_launch_counts()
    out = ops.attention_i8(q, kv, kv, sc, v_scale=vs)
    assert out.dtype == (torch.float32 if v_scale else torch.int32)
    q_ln2, q_b, q_c, es = _exp_consts(sc)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"]) == 23
    assert args[6:12] == (2, 4, 2, 40, 40, d)
    assert args[14:20] == (q_ln2, q_b, q_c, es, *rcp(q_ln2))
    assert seen["argtypes"][18] is build.U
    assert (args[3] != 0) == v_scale
    assert LAUNCHES["int8_flash_attention"] == 1
    assert LAUNCHES["int8_flash_attention.streaming"] == 1


def test_attention_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel (here the build, which raises),
    at any key count."""
    monkeypatch.setattr(ifa, "on_cuda", lambda *a: True)
    _no_build(monkeypatch)
    for t in (16, 5000):
        q = torch.zeros((1, 2, t, 64), dtype=torch.int8)
        with pytest.raises(RuntimeError, match="no nvcc here"):
            ops.attention_i8(q, q, q, int_score_scale(64))


# ---------------------------------------------------------------------------
# ssd_scan: scratch, entry, the decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,p,n", [(4, 1024, 80, 64, 64),
                                       (4, 512, 2, 64, 16),
                                       (1, 128, 3, 64, 16)])
def test_ssd_scratch_sizes(monkeypatch, b, t, h, p, n):
    """C.B^T once per (lane, chunk), every chunk's state, the chunk decays:
    2 MB and 42 MB at zamba2-2.7b's [4, 1024, 80] x (64, 64)."""
    nc = t // ssd.CHUNK
    sizes = ssd.scratch_floats(b, t, h, p, n)
    assert sizes == {"cbt": b * nc * 128 * 128, "states": b * nc * h * n * p,
                     "decay": b * nc * h}
    if (b, t, h) == (4, 1024, 80):
        assert 4 * sizes["cbt"] == 2 * 2 ** 20
        assert 4 * sizes["states"] == 4 * 8 * 80 * 64 * 64 * 4
    seen, made = {}, []
    _fake_card(monkeypatch, ssd, seen)
    real_empty = torch.empty

    def empty(*shape, **kw):
        made.append(tuple(shape[0]) if isinstance(shape[0], tuple)
                    else shape)
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    x = torch.zeros((b, t, h, p))
    ops.reset_launch_counts()
    ssd.ssd_scan(x, torch.zeros((b, t, h)), -torch.ones(h),
                 torch.zeros((b, t, n)), torch.zeros((b, t, n)))
    assert (sum(sizes.values()),) in made
    args = seen["args"]
    assert len(args) == len(seen["argtypes"]) == 14
    assert args[8:13] == (b, t, h, p, n)
    assert LAUNCHES["ssd_scan"] == 1


def _chunk_parallel(x, dt, a, bm, cm, chunk=ssd.CHUNK):
    """The four kernels' decomposition in f64: C.B^T once per (lane, chunk)
    over the triangle, each chunk's own state and decay, the sequential
    pass (each chunk's state replaced by the one before it), then
    y = exp(cum_i) C_i . H_prev + (C.B^T o exp(cum_i - cum_j) o dt_j) x."""
    b, t, h, p = x.shape
    n = bm.shape[-1]
    nc = t // chunk
    out_y = torch.empty_like(x)
    states = torch.empty((b, nc, h, n, p), dtype=x.dtype)
    dec = torch.empty((b, nc, h), dtype=x.dtype)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    cbt = {}
    for bi in range(b):
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            cbt[bi, c] = torch.where(tri, cm[bi, sl] @ bm[bi, sl].T, 0.0)
            for hh in range(h):
                cum = torch.cumsum(dt[bi, sl, hh] * a[hh], 0)
                wj = torch.exp(cum[-1] - cum) * dt[bi, sl, hh]
                states[bi, c, hh] = bm[bi, sl].T @ (wj[:, None] * x[bi, sl, hh])
                dec[bi, c, hh] = torch.exp(cum[-1])
    final = torch.zeros((b, h, n, p), dtype=x.dtype)
    for c in range(nc):
        s_c = states[:, c].clone()
        states[:, c] = final
        final = dec[:, c, :, None, None] * final + s_c
    for bi in range(b):
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            for hh in range(h):
                cum = torch.cumsum(dt[bi, sl, hh] * a[hh], 0)
                e = torch.exp(torch.where(tri, cum[:, None] - cum[None], -1e30))
                w = cbt[bi, c] * e * dt[bi, sl, hh][None]
                inter = torch.exp(cum)[:, None] * (cm[bi, sl] @ states[bi, c, hh])
                out_y[bi, sl, hh] = inter + w @ x[bi, sl, hh]
    return out_y, final


@pytest.mark.parametrize("b,t,h,n", [(1, 256, 3, 16), (2, 384, 5, 8)])
def test_chunk_parallel_decomposition_matches_the_plain_version(b, t, h, n):
    rng = np.random.default_rng(b * 100 + t + h)
    p = 64
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)) - 1.0))
    a = -np.linspace(1.0, 16.0, h)
    bm, cm = (rng.standard_normal((b, t, n)) for _ in range(2))
    args64 = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    y, st = _chunk_parallel(*args64)
    yr, sr = ssd.ssd_scan_ref(*args64)
    torch.testing.assert_close(y, yr, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(st, sr, rtol=1e-10, atol=1e-10)
    # and the reference's own chunked scan (f32 under jit) within the
    # kernel's tolerance
    jy = np.asarray(jax.jit(lambda *v: j_ssd_chunked(*v, chunk=ssd.CHUNK)[0])(
        *(jnp.asarray(v, jnp.float32) for v in (x, dt, a, bm, cm))))
    np.testing.assert_allclose(y.numpy(), jy, rtol=ssd.RTOL, atol=ssd.ATOL)


def test_ssd_scan_refuses_ragged_chunks_on_the_card(monkeypatch):
    """T must be a positive multiple of the kernel's chunk: anything else
    raises before the build, never a fallback to the plain version."""
    monkeypatch.setattr(ssd, "on_cuda", lambda *a: True)
    _no_build(monkeypatch)
    for t in (0, 100, 130):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ops.ssd_scan(torch.zeros(1, t, 2, 64), torch.zeros(1, t, 2),
                         -torch.ones(2), torch.zeros(1, t, 16),
                         torch.zeros(1, t, 16))
    with pytest.raises(RuntimeError, match="no nvcc here"):
        ops.ssd_scan(torch.zeros(1, 256, 2, 64), torch.zeros(1, 256, 2),
                     -torch.ones(2), torch.zeros(1, 256, 16),
                     torch.zeros(1, 256, 16))
