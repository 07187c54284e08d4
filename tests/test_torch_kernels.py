"""The port's kernels against the JAX reference, on the CPU.

Each plain PyTorch version (what a CPU tensor runs) is held against
``jax.jit`` of its ``repro.kernels.ref`` oracle and against the Pallas kernel
in interpret mode, on the same numpy inputs: quantize_rows, int8_gemm,
int4_gemm, the integer dual_gemm_gated and dual_int4_gemm_gated, and
int_layernorm bit-exact; the float dual_gemm_gated within ``BF16_TOL``; the
decode attention within its stated tolerance.
The CUDA kernels themselves are held against the plain versions on the card
by the ``cuda``-marked tests at the end (skipped without a card) and by
``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref
from repro.kernels.common import set_interpret
from repro.kernels.int8_gemm import dual_gemm_gated as pallas_dual
from repro.kernels.int8_gemm import dual_int4_gemm_gated as pallas_dual_int4
from repro.kernels.int8_gemm import int4_gemm as pallas_int4
from repro.kernels.int8_gemm import int8_gemm as pallas_gemm
from repro.kernels.quantize import pack_int4 as j_pack_int4
from repro.kernels.quantize import unpack_int4 as j_unpack_int4
from repro.models.layers import quantize_weight_w4 as j_quantize_w4
from repro.kernels.int8_kv_decode_attention import (
    int8_kv_decode_attention as pallas_decode)
from repro.kernels.int_layernorm import int_layernorm as pallas_ln
from repro.kernels.quantize import quantize_rows as pallas_quant

from repro_torch.kernels import ops
from repro_torch.kernels.common import fma_f32, rcp32
from repro_torch.kernels import int8_gemm as tg
from repro_torch.kernels import autotune as at
from repro_torch.kernels.autotune import split_k
from repro_torch.kernels.int8_gemm import gemm_w8a8_ref, int8_matmul_ref
from repro_torch.kernels.quantize import pack_int4
from repro_torch.kernels.int8_kv_decode_attention import (
    ATOL, ROWS_SMEM, RTOL, block_smem, int8_kv_decode_attention_ref,
    int8_kv_decode_attention_rows_ref, rows_per_block)
from repro_torch.kernels.int_layernorm import int_layernorm_ref
from repro_torch.kernels.quantize import quantize_rows_ref

GELU = 8.0 / 127.0
SILU = 8.0 / 127.0
# float gated MLP, port vs jax.jit on the CPU: both round the two GEMMs, the
# activation and the product to bf16, at points XLA and PyTorch may place
# differently (one bf16 ulp = 2^-7 relative each), so allow a few ulps
BF16_TOL = dict(rtol=2.0 ** -5, atol=2.0 ** -7)


@pytest.fixture(autouse=True)
def _interpret():
    set_interpret(True)


@pytest.fixture(autouse=True)
def _table_only(monkeypatch, tmp_path):
    """The port's tilings are autotune's tables: no measured cache of this
    machine."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    at.reset_measured_cache()
    yield
    at.reset_measured_cache()


def T(a):
    return torch.from_numpy(np.array(a))


def bits_equal(port: torch.Tensor, jx) -> bool:
    a = port.float().numpy() if port.dtype == torch.bfloat16 else port.numpy()
    b = np.asarray(jnp.asarray(jx).astype(jnp.float32)
                   if jnp.asarray(jx).dtype == jnp.bfloat16 else jx)
    return a.shape == b.shape and np.array_equal(a, b)


def rows(rng, m, d):
    """f32 rows with a wide dynamic range, a zero row (the 1e-8 floor)."""
    x = rng.standard_normal((m, d)) * rng.uniform(1e-3, 30.0, (m, 1))
    x[0] = 0.0
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# the two XLA behaviours the port reproduces
# ---------------------------------------------------------------------------

class TestJitNumerics:
    def test_division_by_constant_is_reciprocal_product(self, rng):
        a = rng.standard_normal(1 << 16).astype(np.float32) * 100
        for c in (127.0, GELU):
            got = np.asarray(jax.jit(lambda v: v / c)(a))
            assert np.array_equal(got, a * rcp32(c))

    def test_fma_f32_matches_contracted_bias_epilogue(self, rng):
        a, b, c = (rng.standard_normal(1 << 16).astype(np.float32)
                   * rng.uniform(1e-3, 1e3, 1 << 16).astype(np.float32)
                   for _ in range(3))
        got = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
        mine = fma_f32(T(a), T(b), T(c)).numpy()
        assert np.array_equal(mine, got)
        # and it is not the unfused two-rounding form
        assert not np.array_equal((T(a) * T(b) + T(c)).numpy(), got)


# ---------------------------------------------------------------------------
# 1. quantize_rows
# ---------------------------------------------------------------------------

class TestQuantizeRows:
    @pytest.mark.parametrize("m,d", [(8, 64), (5, 3072), (16, 12288)])
    def test_exact_vs_jit_ref(self, rng, m, d):
        x = rows(rng, m, d)
        qj, sj = jax.jit(ref.quantize_rows_ref)(x)
        q, s = quantize_rows_ref(T(x))
        assert bits_equal(q, qj) and bits_equal(s, sj)

    def test_exact_vs_pallas_interpret(self, rng):
        x = rows(rng, 16, 256)
        qp, sp = pallas_quant(jnp.asarray(x), bm=8, interpret=True)
        q, s = quantize_rows_ref(T(x))
        assert bits_equal(q, qp) and bits_equal(s, sp)

    def test_ops_lead_dims(self, rng):
        x = rows(rng, 6, 32).reshape(2, 3, 32)
        q, s = ops.quant_rows(T(x))
        qj, sj = jax.jit(ref.quantize_rows_ref)(x.reshape(6, 32))
        assert q.shape == (2, 3, 32) and s.shape == (2, 3, 1)
        assert bits_equal(q.reshape(6, 32), qj)
        assert bits_equal(s.reshape(6, 1), sj)


# ---------------------------------------------------------------------------
# 2. int8_gemm (W8A8 epilogues)
# ---------------------------------------------------------------------------

def gemm_inputs(rng, m, k, n):
    xq, xs = (np.asarray(a) for a in jax.jit(ref.quantize_rows_ref)(
        rng.standard_normal((m, k)).astype(np.float32)))
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    ws = (np.abs(w).max(0) / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / ws), -128, 127).astype(np.int8)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    res = jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
    return xq, xs, wq, ws, bias, res


CASES = [  # (label, kwargs of gemm_w8a8_ref beyond the operands)
    ("scaled", {}),
    ("scaled+bias", {"bias": True}),
    ("scaled_add", {"residual": True}),
    ("scaled_add+bias", {"bias": True, "residual": True}),
    ("scaled_gelu", {"gelu_scale": GELU}),
    ("head_f32", {"out_dtype": "f32"}),
]


def _kw(spec, bias, res, for_torch):
    kw = {}
    if spec.get("bias"):
        kw["bias"] = T(bias) if for_torch else bias
    if spec.get("residual"):
        kw["residual"] = (torch.from_numpy(np.array(res.astype(jnp.float32)))
                          .to(torch.bfloat16) if for_torch else res)
    if "gelu_scale" in spec:
        kw["gelu_scale"] = spec["gelu_scale"]
    if spec.get("out_dtype") == "f32":
        kw["out_dtype"] = torch.float32 if for_torch else jnp.float32
    return kw


class TestInt8Gemm:
    @pytest.mark.parametrize("label,spec", CASES, ids=[c[0] for c in CASES])
    @pytest.mark.parametrize("m,k,n", [(8, 64, 48), (13, 100, 70),
                                       (4, 3072, 64)])
    def test_exact_vs_jit_ref(self, rng, label, spec, m, k, n):
        xq, xs, wq, ws, bias, res = gemm_inputs(rng, m, k, n)
        jkw = _kw(spec, bias, res, False)
        want = jax.jit(lambda *a: ref.gemm_w8a8_ref(*a, **jkw))(xq, xs, wq, ws)
        got = gemm_w8a8_ref(T(xq), T(xs), T(wq), T(ws),
                            **_kw(spec, bias, res, True))
        assert bits_equal(got, want), label

    @pytest.mark.parametrize("label,spec", CASES, ids=[c[0] for c in CASES])
    def test_exact_vs_pallas_interpret(self, rng, label, spec):
        m, k, n = 8, 128, 128
        xq, xs, wq, ws, bias, res = gemm_inputs(rng, m, k, n)
        epi = ("scaled_gelu" if "gelu_scale" in spec else
               "scaled_add" if spec.get("residual") else "scaled")
        out_dtype = jnp.float32 if spec.get("out_dtype") else jnp.bfloat16
        want = pallas_gemm(
            jnp.asarray(xq), jnp.asarray(wq), epilogue=epi,
            gelu_scale=spec.get("gelu_scale"), x_scale=jnp.asarray(xs),
            w_scale=jnp.asarray(ws).reshape(1, n),
            bias=jnp.asarray(bias).reshape(1, n) if spec.get("bias") else None,
            residual=res if spec.get("residual") else None,
            out_dtype=out_dtype, bm=8, bn=128, bk=128, interpret=True)
        got = gemm_w8a8_ref(T(xq), T(xs), T(wq), T(ws),
                            **_kw(spec, bias, res, True))
        assert bits_equal(got, want), label

    def test_accumulator_exact(self, rng):
        xq = rng.integers(-128, 128, (9, 300)).astype(np.int8)
        wq = rng.integers(-128, 128, (300, 40)).astype(np.int8)
        want = jax.jit(ref.int8_gemm_ref)(xq, wq)
        assert bits_equal(int8_matmul_ref(T(xq), T(wq)), want)

    def test_ops_lead_dims(self, rng):
        xq, xs, wq, ws, bias, _ = gemm_inputs(rng, 6, 64, 32)
        got = ops.gemm_w8a8(T(xq).reshape(2, 3, 64), T(xs).reshape(2, 3, 1),
                            T(wq), T(ws), bias=T(bias))
        want = jax.jit(lambda *a: ref.gemm_w8a8_ref(*a, bias=bias))(
            xq, xs, wq, ws)
        assert got.shape == (2, 3, 32)
        assert bits_equal(got.reshape(6, 32), want)

    @pytest.mark.parametrize("m,n,k", [(8, 3072, 3072), (8, 256, 3072),
                                       (2048, 12288, 3072), (5, 70, 100),
                                       (8, 92416, 4096), (64, 4096, 13440),
                                       (256, 256, 3072), (4096, 3072, 12288),
                                       (13, 70, 100)])
    def test_split_k_covers_k_exactly(self, m, n, k):
        """The split of K covers it exactly, in whole stages: by default and
        in the single-stream W8 tiling int8_gemm launches."""
        split, k_len = split_k(m, n, k, n_sm=132)
        assert k_len % 64 == 0 and split >= 1
        assert (split - 1) * k_len < k <= split * k_len
        t = at.gemm_blocks(m, k, n, 132)
        assert t.k_len % tg.W8_BK == 0 and t.split >= 1
        assert (t.split - 1) * t.k_len < k <= t.split * t.k_len
        assert t.workspace == (m * n if t.split > 1 else 0)

    @pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 33, 63, 64, 65, 256,
                                   4096])
    @pytest.mark.parametrize("n,k", [(3072, 3072), (256, 3072),
                                     (12288, 3072), (3072, 12288),
                                     (4096, 13440), (92416, 4096)])
    def test_int8_gemm_tiling(self, m, n, k):
        """int8_gemm's single-stream W8 tiling at starcoder2-3b's and
        codeqwen1.5-7b's widths: 16-row decode blocks exactly up to
        W8_DECODE_M (no row computed past the next multiple of 16) where the
        weight fits W8_DECODE_BYTES (every projection; not the heads), 64 x
        128 prefill blocks past it, 128 x 128 at deep K (the down
        projections) from W8_WIDE_M rows; at decode, K split until ~32 KB
        of weight is in flight per SM (within the halving that whole stages
        per split can cost) unless K cannot split further; past it, only a
        grid under two blocks an SM is split."""
        n_sm = 132
        t = at.gemm_blocks(m, k, n, n_sm)
        decode = m <= at.W8_DECODE_M and k * n <= at.W8_DECODE_BYTES
        assert decode == (m <= 64 and n != 92416)
        wide = k >= 8192 and m >= 1024
        assert (t.bm, t.bn) == ((16, 128) if decode else (128, 128) if wide
                                else (64, 128))
        assert at.MMA_CONFIGS[("w8", 1, t.bm)][0] == t.bn
        assert t.tiles == -(-m // t.bm) * -(-n // t.bn)
        if decode:
            assert t.bm * -(-m // t.bm) - m < 16
            in_flight = (tg.W4_STAGES - 1) * at.MMA_STAGE_ROWS * t.bn
            if t.k_len > tg.W8_BK:
                assert 2 * t.tiles * t.split * in_flight >= at.W4_INFLIGHT * n_sm
        elif t.split > 1:
            assert t.tiles < 2 * n_sm


# ---------------------------------------------------------------------------
# int4 container, W4A8 and gated-MLP plain versions
# ---------------------------------------------------------------------------

class TestInt4Pack:
    @pytest.mark.parametrize("k,n", [(8, 5), (7, 3), (64, 48), (1, 4)])
    def test_pack_unpack_vs_jax(self, rng, k, n):
        w = rng.integers(-8, 8, (2, k, n)).astype(np.int8)
        packed = pack_int4(T(w))
        want = j_pack_int4(jnp.asarray(w))
        assert bits_equal(packed, want)
        assert bits_equal(tg.unpack_int4_ref(packed, k), j_unpack_int4(want, k))
        assert bits_equal(tg.unpack_int4_ref(packed, k),
                          ref.unpack_int4_ref(want, k))
        assert np.array_equal(tg.unpack_int4_ref(packed, k).numpy(), w)


def w4_inputs(rng, k, n, group):
    """x [k], packed int4 weight (the reference's quantize_weight_w4 of a
    random f32 weight), bias, the W8A8 operands of the same shape."""
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    q = {a: np.asarray(b) for a, b in
         j_quantize_w4(jnp.asarray(w), group=group).items()}
    return q["w4"], q["qmul"], q["scale"]


W4_CASES = [  # (label, kwargs of gemm_w4a8_ref beyond the operands)
    ("scaled", {}),
    ("scaled+bias", {"bias": True}),
    ("scaled_add", {"residual": True}),
    ("scaled_gelu", {"gelu_scale": GELU}),
    ("head_f32", {"out_dtype": "f32"}),
]


class TestW4A8Gemm:
    @pytest.mark.parametrize("label,spec", W4_CASES, ids=[c[0] for c in W4_CASES])
    @pytest.mark.parametrize("group", [32, 64, 128])
    @pytest.mark.parametrize("m", [8, 13])
    def test_exact_vs_jit_ref(self, rng, label, spec, group, m):
        k, n = 256, 72
        xq, xs, _, _, bias, res = gemm_inputs(rng, m, k, n)
        w4, qmul, ws = w4_inputs(rng, k, n, group)
        jkw = _kw(spec, bias, res, False)
        want = jax.jit(lambda *a: ref.gemm_w4a8_ref(*a, **jkw))(
            xq, xs, w4, qmul, ws)
        got = tg.gemm_w4a8_ref(T(xq), T(xs), T(w4), T(qmul), T(ws),
                               **_kw(spec, bias, res, True))
        assert bits_equal(got, want), label

    @pytest.mark.parametrize("label,spec", W4_CASES[:4],
                             ids=[c[0] for c in W4_CASES[:4]])
    def test_exact_vs_pallas_interpret(self, rng, label, spec):
        m, k, n, group = 8, 256, 128, 64
        xq, xs, _, _, bias, res = gemm_inputs(rng, m, k, n)
        w4, qmul, ws = w4_inputs(rng, k, n, group)
        epi = ("scaled_gelu" if "gelu_scale" in spec else
               "scaled_add" if spec.get("residual") else "scaled")
        want = pallas_int4(
            jnp.asarray(xq), jnp.asarray(w4), jnp.asarray(qmul),
            jnp.asarray(ws), jnp.asarray(xs), group=group, epilogue=epi,
            gelu_scale=spec.get("gelu_scale"),
            bias=jnp.asarray(bias).reshape(1, n) if spec.get("bias") else None,
            residual=res if spec.get("residual") else None,
            bm=8, bn=128, bk=128, interpret=True)
        got = tg.gemm_w4a8_ref(T(xq), T(xs), T(w4), T(qmul), T(ws),
                               **_kw(spec, bias, res, True))
        assert bits_equal(got, want), label

    def test_ops_lead_dims_and_wrapper(self, rng):
        xq, xs, _, _, bias, res = gemm_inputs(rng, 6, 128, 40)
        w4, qmul, ws = w4_inputs(rng, 128, 40, 32)
        rt = _kw({"residual": True}, bias, res, True)["residual"]
        got = ops.gemm_w4a8(T(xq).reshape(2, 3, 128), T(xs).reshape(2, 3, 1),
                            T(w4), T(qmul), T(ws), bias=T(bias),
                            residual=rt.reshape(2, 3, 40))
        want = jax.jit(lambda *a: ref.gemm_w4a8_ref(*a, bias=bias,
                                                    residual=res))(
            xq, xs, w4, qmul, ws)
        assert got.shape == (2, 3, 40)
        assert bits_equal(got.reshape(6, 40), want)

    @pytest.mark.parametrize("m,n,k,g", [(8, 4096, 4096, 64),
                                         (8, 4096, 13440, 64),
                                         (8, 13440, 4096, 128),
                                         (256, 4096, 13440, 32)])
    def test_split_k_lands_on_group_boundaries(self, m, n, k, g):
        split, k_len = split_k(m, n, k, n_sm=132, align=max(64, g))
        assert k_len % max(64, g) == 0 and k_len % g == 0
        assert (split - 1) * k_len < k <= split * k_len

    @pytest.mark.parametrize("m,n,k,g", [
        (1, 4096, 4096, 64), (5, 70, 96, 32), (8, 4096, 13440, 64),
        (8, 13440, 4096, 128), (17, 10448, 2560, 32), (37, 4096, 4096, 64),
        (64, 4096, 13440, 128), (65, 4096, 4096, 64), (256, 4096, 13440, 32),
        (4096, 10448, 2560, 64), (4096, 4096, 13440, 128)])
    def test_w4_tiling(self, m, n, k, g):
        """The tensor-core W4A8 loop's tiles: the decode shape exactly at
        M <= 64 (16-row blocks: no row computed past the next multiple of
        16), K ranges on group boundaries, no empty split, the split-K
        workspace only where K is split, and at decode enough blocks for
        ~32 KB of nibbles in flight per SM unless K cannot split further."""
        n_sm = 132
        t = at.gemm_w4a8_blocks(m, k, n, g, n_sm)
        decode = m <= 64
        assert (t.bm, t.bn) == ((16, 128) if decode else (64, 128))
        if decode:
            rows = t.bm * -(-m // t.bm)
            assert rows == 16 * -(-m // 16) and rows - m < 16
        assert t.k_len % max(tg.W4_BK, g) == 0 and t.k_len % g == 0
        assert (t.split - 1) * t.k_len < k <= t.split * t.k_len
        assert t.tiles == -(-m // t.bm) * -(-n // t.bn)
        assert t.workspace == (m * n if t.split > 1 else 0)
        if decode and t.k_len > max(tg.W4_BK, g):
            in_flight = (tg.W4_STAGES - 1) * tg.W4_BK // 2 * t.bn
            assert t.tiles * t.split * in_flight >= at.W4_INFLIGHT * n_sm

    @pytest.mark.parametrize("g", [32, 64, 128])
    @pytest.mark.parametrize("m,n,k", [
        (1, 13440, 4096), (8, 13440, 4096), (8, 10240, 2560), (13, 72, 256),
        (32, 13440, 4096), (33, 13440, 4096), (64, 13440, 4096),
        (256, 13440, 4096), (4096, 13440, 4096), (8, 256, 1024)])
    def test_dual_w4_tiling(self, m, n, k, g):
        """dual_int4_gemm_gated's two-stream tiling: decode blocks of 16 rows
        up to DUAL_DECODE_M, then 32-row blocks; K ranges on group
        boundaries, no empty split, a workspace for both streams' sums
        ([2][M][N]) exactly when K is split, and at decode enough blocks for
        ~32 KB of both streams' nibbles in flight per SM — no more than one
        stream would ask for."""
        n_sm = 132
        t = at.gatedmlp_w4a8_blocks(m, k, n, g, n_sm)
        one = at.gemm_w4a8_blocks(m, k, n, g, n_sm)
        decode = m <= at.DUAL_DECODE_M
        assert (t.bm, t.bn) == ((16, 128) if decode else (32, 128))
        assert t.k_len % max(tg.W4_BK, g) == 0 and t.k_len % g == 0
        assert (t.split - 1) * t.k_len < k <= t.split * t.k_len
        assert t.tiles == -(-m // t.bm) * -(-n // t.bn)
        assert t.workspace == (2 * m * n if t.split > 1 else 0)
        if decode:
            in_flight = (tg.W4_STAGES - 1) * at.MMA_STAGE_ROWS * t.bn * 2
            if t.k_len > max(tg.W4_BK, g):
                assert t.tiles * t.split * in_flight >= at.W4_INFLIGHT * n_sm
            assert t.split <= one.split

    @pytest.mark.parametrize("m,n,k", [
        (1, 13440, 4096), (8, 13440, 4096), (5, 70, 100), (13, 70, 200),
        (32, 12288, 3072), (64, 13440, 4096), (256, 13440, 4096),
        (4096, 13440, 4096)])
    def test_w8_tiling(self, m, n, k):
        """dual_gemm_gated's int8 tiling: K ranges on multiples of W8_BK, no
        empty split, a [2][M][N] workspace exactly when K is split."""
        t = at.gated_mlp_blocks(m, k, n, "int8", 132)
        assert (t.bm, t.bn) == ((16, 128) if m <= at.DUAL_DECODE_M
                                else (64, 128))
        assert t.k_len % tg.W8_BK == 0
        assert (t.split - 1) * t.k_len < k <= t.split * t.k_len
        assert t.workspace == (2 * m * n if t.split > 1 else 0)

    @pytest.mark.parametrize("m,want", [(1, (16, 64)), (8, (16, 64)),
                                        (32, (16, 64)), (33, (64, 128)),
                                        (128, (64, 128)), (129, (128, 128)),
                                        (4096, (128, 128))])
    def test_bf16_tiling(self, m, want):
        """The bf16 form never splits K (its f32 sums would depend on the
        arrival order), so its decode tile is narrow enough that M = 8 at
        codeqwen1.5-7b's N = 13440 fills 132 SMs."""
        t = at.gated_mlp_blocks(m, 4096, 13440, "bf16", 132)
        assert (t.bm, t.bn) == want and t.split == 1 and t.workspace == 0
        assert t.k_len == 4096
        if m <= at.DUAL_DECODE_M:
            assert t.tiles >= 132

    @pytest.mark.parametrize("cfg", sorted(at.MMA_CONFIGS),
                             ids=lambda c: f"{c[0]}-s{c[1]}-bm{c[2]}")
    def test_mma_shared_memory_fits(self, cfg):
        """Every instantiation of the tensor-core loop fits a block's shared
        memory on the H100, and as many blocks as its launch bounds ask for
        fit an SM (1 KB reserved per block); the configs and kinds mirror
        ``csrc/gemm_mma.cuh``."""
        import re
        from pathlib import Path
        kind, streams, bm = cfg
        bn, blocks = at.MMA_CONFIGS[cfg]
        smem = tg.mma_smem_bytes(kind, bm, bn, streams)
        assert smem <= tg.SMEM_PER_BLOCK
        assert blocks * (smem + 1024) <= tg.SMEM_PER_SM
        src = (Path(tg.__file__).with_name("csrc") / "gemm_mma.cuh").read_text()
        cfgs = {(16 * int(mt) * int(wm), 16 * int(np_) * int(wn), int(mb or 1))
                for wm, wn, mt, np_, mb in re.findall(
                    r"using \w+ = Cfg<(\d+), (\d+), (\d+), (\d+)(?:, (\d+))?>;",
                    src)}
        assert (bm, bn, blocks) in cfgs
        bk, a_elem, w_rows, w_elem = tg.MMA_KINDS[kind]
        body = re.search(r"struct %s \{(.*?)\};" % kind.upper(), src, re.S)
        assert f"BK = {bk}, A_ELEM = {a_elem}" in body.group(1)
        assert f"W_ELEM = {w_elem}" in body.group(1)
        assert w_rows == (bk // 2 if kind == "w4" else bk)

    def test_headroom_is_checked(self):
        x = torch.zeros((1, 32768), dtype=torch.int8)
        with pytest.raises(ValueError, match="int32 combine"):
            tg.gemm_w4a8_ref(x, torch.ones(1, 1), torch.zeros(
                (16384, 4), dtype=torch.int8), torch.ones(
                (512, 4), dtype=torch.int8), torch.ones(4))


def dual_inputs(rng, m, k, n, group=None):
    xq, xs, wu, us, _, _ = gemm_inputs(rng, m, k, n)
    _, _, wg, gs, _, _ = gemm_inputs(rng, m, k, n)
    if group is None:
        return xq, xs, (wu, us), (wg, gs)
    return xq, xs, w4_inputs(rng, k, n, group), w4_inputs(rng, k, n, group)


class TestGatedMLP:
    @pytest.mark.parametrize("act", ["silu", "gelu"])
    @pytest.mark.parametrize("m,k,n", [(8, 64, 128), (13, 100, 70)])
    def test_w8a8_exact_vs_jit_ref(self, rng, act, m, k, n):
        xq, xs, (wu, us), (wg, gs) = dual_inputs(rng, m, k, n)
        sc = SILU if act == "silu" else GELU
        want = jax.jit(lambda *a: ref.gated_mlp_w8a8_ref(
            *a, act=act, act_scale=sc))(xq, xs, wu, us, wg, gs)
        got = tg.gated_mlp_w8a8_ref(*map(T, (xq, xs, wu, us, wg, gs)),
                                    act=act, act_scale=sc)
        assert bits_equal(got, want)

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    @pytest.mark.parametrize("group", [32, 64, 128])
    def test_w4a8_exact_vs_jit_ref(self, rng, act, group):
        xq, xs, up, gate = dual_inputs(rng, 13, 256, 72, group)
        sc = SILU if act == "silu" else GELU
        want = jax.jit(lambda *a: ref.gated_mlp_w4a8_ref(
            *a, act=act, act_scale=sc))(xq, xs, *up, *gate)
        got = tg.gated_mlp_w4a8_ref(T(xq), T(xs), *map(T, up), *map(T, gate),
                                    act=act, act_scale=sc)
        assert bits_equal(got, want)

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_float_close_vs_jit_ref(self, rng, act):
        m, k, n = 12, 96, 80
        x = rng.standard_normal((m, k)).astype(np.float32)
        wu, wg = ((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
                  for _ in range(2))
        want = np.asarray(jax.jit(lambda *a: ref.gated_mlp_ref(*a, act=act))(
            x, wu, wg).astype(jnp.float32))
        got = tg.gated_mlp_ref(T(x), T(wu), T(wg), act).float().numpy()
        np.testing.assert_allclose(got, want, **BF16_TOL)

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_w8a8_exact_vs_pallas_interpret(self, rng, act):
        m, k, n = 8, 128, 128
        xq, xs, (wu, us), (wg, gs) = dual_inputs(rng, m, k, n)
        sc = SILU if act == "silu" else GELU
        want = pallas_dual(jnp.asarray(xq), jnp.asarray(wu), jnp.asarray(wg),
                           x_scale=jnp.asarray(xs),
                           up_scale=jnp.asarray(us).reshape(1, n),
                           gate_scale=jnp.asarray(gs).reshape(1, n), act=act,
                           act_scale=sc, bm=8, bn=128, bk=128, interpret=True)
        got = ops.gated_mlp_w8a8(*map(T, (xq, xs, wu, us, wg, gs)), act=act,
                                 act_scale=sc)
        assert bits_equal(got, want)

    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_w4a8_exact_vs_pallas_interpret(self, rng, act):
        m, k, n, group = 8, 256, 128, 64
        xq, xs, up, gate = dual_inputs(rng, m, k, n, group)
        sc = SILU if act == "silu" else GELU
        want = pallas_dual_int4(jnp.asarray(xq), *map(jnp.asarray, up),
                                *map(jnp.asarray, gate), jnp.asarray(xs),
                                group=group, act=act, act_scale=sc, bm=8,
                                bn=128, bk=128, interpret=True)
        got = ops.gated_mlp_w4a8(T(xq), T(xs), *map(T, up), *map(T, gate),
                                 act=act, act_scale=sc)
        assert bits_equal(got, want)

    def test_float_close_vs_pallas_interpret(self, rng):
        m, k, n = 8, 128, 128
        x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
        wu, wg = (jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k),
                              jnp.bfloat16) for _ in range(2))
        want = np.asarray(pallas_dual(x, wu, wg, act="silu", bm=8, bn=128,
                                      bk=128, interpret=True
                                      ).astype(jnp.float32))
        got = ops.gated_mlp(*(T(np.asarray(a.astype(jnp.float32))).bfloat16()
                              for a in (x, wu, wg)), "silu")
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)

    def test_ops_lead_dims(self, rng):
        xq, xs, up, gate = dual_inputs(rng, 6, 128, 40, 64)
        got = ops.gated_mlp_w4a8(T(xq).reshape(3, 2, 128),
                                 T(xs).reshape(3, 2, 1), *map(T, up),
                                 *map(T, gate), act="silu", act_scale=SILU)
        want = jax.jit(lambda *a: ref.gated_mlp_w4a8_ref(
            *a, act="silu", act_scale=SILU))(xq, xs, *up, *gate)
        assert got.shape == (3, 2, 40)
        assert bits_equal(got.reshape(6, 40), want)


# ---------------------------------------------------------------------------
# 3. int_layernorm
# ---------------------------------------------------------------------------

def ln_inputs(rng, m, d):
    x = rng.integers(-128, 128, (m, d)).astype(np.int32)
    x[0] -= 90                     # negative mean: floor division matters
    x[-1] = np.abs(x[-1])          # positive mean
    g = rng.integers(-128, 128, (d,)).astype(np.int32)
    b = rng.integers(-128, 128, (d,)).astype(np.int32)
    return x, g, b


class TestIntLayerNorm:
    @pytest.mark.parametrize("rms", [False, True])
    @pytest.mark.parametrize("m,d", [(8, 64), (3, 3072), (2, 40000)])
    def test_exact_vs_jit_ref(self, rng, rms, m, d):
        x, g, b = ln_inputs(rng, m, d)
        want = jax.jit(lambda *a: ref.int_layernorm_ref(*a, rms_only=rms))(
            x, g, b)
        assert bits_equal(int_layernorm_ref(T(x), T(g), T(b), rms), want)

    @pytest.mark.parametrize("rms", [False, True])
    def test_exact_vs_pallas_interpret(self, rng, rms):
        x, g, b = ln_inputs(rng, 8, 256)
        want = pallas_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                         rms_only=rms, bm=8, interpret=True)
        got = ops.layernorm_i8(T(x), T(g), T(b), rms_only=rms)
        assert bits_equal(got, want)


# ---------------------------------------------------------------------------
# 4. int8_kv_decode_attention
# ---------------------------------------------------------------------------

def decode_inputs(rng, b=4, s=64, hq=4, hkv=2, d=16, dtype=jnp.bfloat16):
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    k_s = (np.abs(k).max(-1, keepdims=True) / 127.0).astype(np.float32)
    v_s = (np.abs(v).max(-1, keepdims=True) / 127.0).astype(np.float32)
    k_q = np.clip(np.round(k / k_s), -128, 127).astype(np.int8)
    v_q = np.clip(np.round(v / v_s), -128, 127).astype(np.int8)
    fill = rng.integers(1, s + 1, b)
    fill[1] = 0                                   # idle lane: all masked
    slot = np.arange(s)
    pos = np.where(slot[None] < fill[:, None], slot[None], -1).astype(np.int32)
    qpos = (fill - 1).astype(np.int32)
    q = jnp.asarray(rng.standard_normal((b, hq, d)), dtype)
    return q, k_q, k_s, v_q, v_s, pos, qpos


def _t_q(q):
    return torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        torch.bfloat16 if q.dtype == jnp.bfloat16 else torch.float32)


class TestDecodeAttention:
    @pytest.mark.parametrize("window", [0, 8])
    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
    def test_close_vs_jit_ref(self, rng, window, dtype):
        q, *rest = decode_inputs(rng, dtype=dtype)
        want = jax.jit(lambda *a: ref.int8_kv_decode_attention_ref(
            *a, window=window))(q, *rest)
        got = int8_kv_decode_attention_ref(_t_q(q), *map(T, rest),
                                           window=window)
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=RTOL, atol=ATOL)
        assert np.isfinite(got.float().numpy()).all()

    @pytest.mark.parametrize("window", [0, 8])
    def test_close_vs_pallas_interpret(self, rng, window):
        q, *rest = decode_inputs(rng)
        want = pallas_decode(q, *map(jnp.asarray, rest), window=window,
                             bk=16, interpret=True)
        got = ops.decode_attention_int8kv(_t_q(q), *map(T, rest), window=window)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=RTOL, atol=ATOL)

    def test_all_masked_lane_is_mean_of_v(self, rng):
        q, k_q, k_s, v_q, v_s, pos, qpos = decode_inputs(rng, dtype=jnp.float32)
        got = int8_kv_decode_attention_ref(_t_q(q), *map(T, (k_q, k_s, v_q,
                                                             v_s, pos, qpos)))
        v = (v_q.astype(np.float32) * v_s)[1].mean(0)     # (Hkv, D), lane 1
        g = q.shape[1] // v.shape[0]
        np.testing.assert_allclose(got[1].numpy(), np.repeat(v, g, 0),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("blocks,s", [(16, 1024), (16, 64), (4, 16),
                                          (1, 100)])
    def test_kv_split_chunks_cover_cache(self, blocks, s):
        n_split, chunk = at.decode_blocks(blocks, s, 128, 1, 132)
        assert chunk % 32 == 0 and (n_split - 1) * chunk < s <= n_split * chunk

    @pytest.mark.parametrize("blocks,s,want", [(256, 1024, (2, 512)),
                                               (16, 1024, (16, 64)),
                                               (512, 1024, (1, 1024)),
                                               (64, 4096, (5, 832))])
    def test_kv_split_serving_values(self, blocks, s, want):
        """The split of the serving paths' caches (codeqwen1.5-7b's 8 x 32
        (lane, kv head) blocks, starcoder2-3b's 8 x 2, 16 lanes of codeqwen)
        is the one every row's sum order follows: a change here moves bits."""
        assert at.decode_blocks(blocks, s, 128, 1, 132) == want


class TestDecodeAttentionRows:
    """The multi-row form (the rows of a packed t > 1 step, ROADMAP C3)."""

    def _rows(self, rng, t=5, dtype=jnp.bfloat16):
        q, k_q, k_s, v_q, v_s, pos, qpos = decode_inputs(rng, dtype=dtype)
        b, hq, d = q.shape
        qr = jnp.asarray(rng.standard_normal((b, t, hq, d)), dtype)
        # each row its own position: a lane's last t slots, a pad row (-1)
        # and, on lane 1, every row idle
        qp = (qpos[:, None] - np.arange(t)[::-1][None]).astype(np.int32)
        qp[0, 0] = -1
        qp[1] = -1
        return qr, k_q, k_s, v_q, v_s, pos, qp

    def test_rows_equal_single_row_launches(self, rng):
        """Row i of the multi-row plain version is the T = 1 plain version
        at that row's position, bit for bit."""
        qr, *rest, qp = self._rows(rng)
        args = [T(a) for a in rest]
        got = ops.decode_attention_int8kv_rows(_t_q(qr), *args, T(qp))
        assert got.shape == tuple(qr.shape) and got.dtype == torch.bfloat16
        for i in range(qr.shape[1]):
            one = ops.decode_attention_int8kv(_t_q(qr[:, i]), *args,
                                              T(qp[:, i]).contiguous())
            assert torch.equal(got[:, i], one)

    @pytest.mark.parametrize("window", [0, 8])
    def test_rows_close_vs_jit_ref(self, rng, window):
        qr, *rest, qp = self._rows(rng, dtype=jnp.float32)
        got = int8_kv_decode_attention_rows_ref(_t_q(qr), *map(T, rest),
                                                T(qp), window=window)
        f = jax.jit(lambda q, qpos: ref.int8_kv_decode_attention_ref(
            q, *rest, qpos, window=window))
        for i in range(qr.shape[1]):
            np.testing.assert_allclose(got[:, i].numpy(),
                                       np.asarray(f(qr[:, i], qp[:, i])),
                                       rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("t,g,d,want", [(1, 1, 128, 1), (256, 1, 128, 16),
                                            (3, 1, 128, 3), (256, 12, 128, 4),
                                            (256, 32, 128, 2)])
    def test_rows_per_block_fit(self, t, g, d, want):
        """Up to 16 rows of a lane share a block (and each K/V tile read),
        fewer where G heads of them would not fit ``ROWS_SMEM`` beside the
        copy ring."""
        assert rows_per_block(t, g, d) == want
        assert block_smem(g, d, want) <= ROWS_SMEM

    @pytest.mark.parametrize("kv_bytes", [1, 2])
    @pytest.mark.parametrize("t", [1, 256])
    @pytest.mark.parametrize("d", [64, 80, 128])
    @pytest.mark.parametrize("g", [1, 6, 7, 12])
    def test_block_smem_fits(self, g, d, t, kv_bytes):
        """The decode body's shared memory (the ring of STAGES raw K and V
        tiles with their scales, then the per-(row, head) state and the
        prescan) at
        the rows ``rows_per_block`` picks: within ``ROWS_SMEM`` and an H100
        block's limit, and at T = 1 over int8 payloads (the serving paths')
        small enough for four blocks an SM (1 KB reserved each).  The layout mirrors ``csrc/decode_tile.cuh``'s
        ``smem_bytes`` term by term."""
        import re
        from pathlib import Path
        from repro_torch.kernels import int8_kv_decode_attention as dk
        rows = rows_per_block(t, g, d, kv_bytes)
        smem = block_smem(g, d, rows, kv_bytes)
        assert smem <= ROWS_SMEM <= tg.SMEM_PER_BLOCK
        if t == 1 and kv_bytes == 1:
            assert 4 * (smem + 1024) <= tg.SMEM_PER_SM
        rb = d * kv_bytes
        ldk = rb + (16 if (rb // 16) % 2 == 0 else 0)
        assert (ldk // 16) % 2 == 1            # an odd number of 16-byte chunks
        src = (Path(dk.__file__).with_name("csrc") / "decode_tile.cuh").read_text()
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
        assert (int(consts["NR"]), int(consts["STAGES"]), int(consts["SEG"]),
                int(consts["BS"])) == (dk.NR, dk.STAGES, dk.SEG, dk.BS)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version (skipped here)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card (chip_smoke.py covers them there)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    def test_quantize_rows(self, rng, cuda_dev):
        x = T(rows(rng, 8, 3072)).to(cuda_dev)
        q, s = ops.quant_rows(x)
        qr, sr = quantize_rows_ref(x)
        assert torch.equal(q, qr) and torch.equal(s, sr)

    @pytest.mark.parametrize("label,spec", CASES, ids=[c[0] for c in CASES])
    def test_int8_gemm(self, rng, cuda_dev, label, spec):
        xq, xs, wq, ws, bias, res = gemm_inputs(rng, 13, 100, 70)
        kw = {k: (v.to(cuda_dev) if isinstance(v, torch.Tensor) else v)
              for k, v in _kw(spec, bias, res, True).items()}
        args = [T(a).to(cuda_dev) for a in (xq, xs, wq, ws)]
        assert torch.equal(ops.gemm_w8a8(*args, **kw), gemm_w8a8_ref(*args, **kw))

    @pytest.mark.parametrize("m", [64, 4096])
    @pytest.mark.parametrize("label,spec", CASES, ids=[c[0] for c in CASES])
    def test_int8_gemm_rows(self, rng, cuda_dev, label, spec, m):
        """M = 64 (the last decode shape of the tensor-core loop) and 4096
        (its prefill shape); K = 320 splits into whole stages."""
        xq, xs, wq, ws, bias, res = gemm_inputs(rng, m, 320, 144)
        kw = {k: (v.to(cuda_dev) if isinstance(v, torch.Tensor) else v)
              for k, v in _kw(spec, bias, res, True).items()}
        args = [T(a).to(cuda_dev) for a in (xq, xs, wq, ws)]
        assert torch.equal(ops.gemm_w8a8(*args, **kw), gemm_w8a8_ref(*args, **kw))

    @pytest.mark.parametrize("m", [64, 4096])
    def test_int8_gemm_rows_requant(self, rng, cuda_dev, m):
        """The integer-out epilogues (none, requant, requant_gelu,
        requant_add) at M = 64 and 4096."""
        from repro_torch.core.inumerics import compute_requant_params
        k, n = 320, 144
        x = T(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda_dev)
        w = T(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda_dev)
        r = T(rng.integers(-128, 128, (m, n)).astype(np.int8)).to(cuda_dev)
        rq = compute_requant_params(1 / (127 * k ** 0.5), acc_bound=k * 127 * 127)
        assert torch.equal(tg.int8_gemm(x, w), int8_matmul_ref(x, w))
        assert torch.equal(ops.gemm_i8(x, w, rq), tg.int8_gemm_ref(x, w, rq))
        assert torch.equal(ops.gemm_i8_gelu(x, w, GELU),
                           tg.int8_gemm_gelu_ref(x, w, GELU))
        assert torch.equal(ops.gemm_i8_add(x, w, rq, r),
                           tg.int8_gemm_add_ref(x, w, rq, r))

    def test_int_layernorm(self, rng, cuda_dev):
        x, g, b = (T(a).to(cuda_dev) for a in ln_inputs(rng, 8, 3072))
        for rms in (False, True):
            assert torch.equal(ops.layernorm_i8(x, g, b, rms),
                               int_layernorm_ref(x, g, b, rms))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d,rms", [(3072, False), (4096, True),
                                       (2560, True)])
    def test_int_layernorm_rows(self, rng, cuda_dev, d, rms, dtype):
        """The fused norm -> quantize form against its plain version, all
        three outputs (an all-zero row, a row of negative mean)."""
        from repro_torch.kernels.int_layernorm import int_layernorm_rows_ref
        from repro_torch.models.layers import quantize_norm
        x = rng.standard_normal((13, d)).astype(np.float32) * 3
        x[0] = 0.0
        x[1] -= 4.0
        x = T(x).to(dtype).to(cuda_dev)
        g = T(rng.standard_normal(d).astype(np.float32) + 1).to(cuda_dev)
        b = T(rng.standard_normal(d).astype(np.float32) * 0.2).to(cuda_dev)
        consts = quantize_norm(g, None if rms else b)
        got = ops.norm_quant_rows(x, *consts, rms)
        want = int_layernorm_rows_ref(x, *consts, rms)
        assert all(torch.equal(a, w) for a, w in zip(got, want))

    @pytest.mark.parametrize("d,dtype,shift", [
        (100, torch.bfloat16, 0), (16384 + 8, torch.bfloat16, 0),
        (8192 + 4, torch.float32, 0), (4096, torch.bfloat16, 1)])
    def test_int_layernorm_rows_refuses(self, cuda_dev, d, dtype, shift):
        """Rows the fused kernel cannot hold in registers (not a multiple
        of 16 bytes, past 2048 chunks, or off a 16-byte address) raise;
        B1 on the same rows still gives its plain version's bits."""
        from repro_torch.models.layers import Norm
        buf = torch.ones(2 * d + shift, dtype=dtype, device=cuda_dev)
        x = buf[shift:].view(2, d)
        consts = [t.to(cuda_dev) for t in Norm(d, "rmsnorm").int_consts()]
        with pytest.raises(ValueError, match="int_layernorm_rows"):
            ops.norm_quant_rows(x, *consts, True)
        assert all(torch.equal(a, w) for a, w in zip(ops.quant_rows(x),
                                                     quantize_rows_ref(x)))

    @pytest.mark.parametrize("m,d", [(8, 4096), (256, 128), (16, 80),
                                     (8, 13440), (5, 100)])
    def test_quantize_rows_bf16(self, rng, cuda_dev, m, d):
        """bf16 rows read as they are (a warp a row up to 1024, a block past
        it, the element-wise form for a ragged width): the f32 path's bits."""
        x = T(rng.standard_normal((m, d)).astype(np.float32) * 3)
        x = x.bfloat16().to(cuda_dev)
        q, s = ops.quant_rows(x)
        qr, sr = quantize_rows_ref(x)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert all(torch.equal(a, w) for a, w in zip(ops.quant_rows(x.float()),
                                                     (q, s)))

    def test_decode_attention(self, rng, cuda_dev):
        q, *rest = decode_inputs(rng, b=8, s=1024, hq=24, hkv=2, d=128)
        args = [_t_q(q).to(cuda_dev)] + [T(a).to(cuda_dev) for a in rest]
        for window in (0, 100):
            got = ops.decode_attention_int8kv(*args, window=window)
            want = int8_kv_decode_attention_ref(*args, window=window)
            torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("label,spec", W4_CASES, ids=[c[0] for c in W4_CASES])
    def test_int4_gemm(self, rng, cuda_dev, label, spec):
        xq, xs, _, _, bias, res = gemm_inputs(rng, 13, 96, 70)
        w4, qmul, ws = w4_inputs(rng, 96, 70, 32)
        kw = {k: (v.to(cuda_dev) if isinstance(v, torch.Tensor) else v)
              for k, v in _kw(spec, bias, res, True).items()}
        args = [T(a).to(cuda_dev) for a in (xq, xs, w4, qmul, ws)]
        assert torch.equal(ops.gemm_w4a8(*args, **kw),
                           tg.gemm_w4a8_ref(*args, **kw))

    @pytest.mark.parametrize("group", [32, 64, 128])
    def test_int4_gemm_prefill_rows(self, rng, cuda_dev, group):
        """M = 1024: the prefill tile shape of the tensor-core loop."""
        xq, xs, _, _, bias, res = gemm_inputs(rng, 1024, 512, 160)
        w4, qmul, ws = w4_inputs(rng, 512, 160, group)
        kw = {k: (v.to(cuda_dev) if isinstance(v, torch.Tensor) else v)
              for k, v in _kw({"bias": True, "residual": True}, bias, res,
                              True).items()}
        args = [T(a).to(cuda_dev) for a in (xq, xs, w4, qmul, ws)]
        assert torch.equal(ops.gemm_w4a8(*args, **kw),
                           tg.gemm_w4a8_ref(*args, **kw))

    @pytest.mark.parametrize("m", [13, 200])
    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_dual_gemm_gated(self, rng, cuda_dev, act, m):
        """Both forms at a decode shape (M = 13) and a prefill shape (M =
        200: the bf16 form's 128-row blocks); K = 200 takes the int8 form's
        byte loads."""
        sc = SILU if act == "silu" else GELU
        xq, xs, (wu, us), (wg, gs) = dual_inputs(rng, m, 200, 70)
        args = [T(a).to(cuda_dev) for a in (xq, xs, wu, us, wg, gs)]
        assert torch.equal(ops.gated_mlp_w8a8(*args, act=act, act_scale=sc),
                           tg.gated_mlp_w8a8_ref(*args, act=act, act_scale=sc))
        x = T(rng.standard_normal((m, 200)).astype(np.float32)).to(cuda_dev)
        w = [T(rng.standard_normal((200, 70)).astype(np.float32) / 14).to(cuda_dev)
             for _ in range(2)]
        got = ops.gated_mlp(x, *w, act).float()
        want = tg.gated_mlp_ref(x, *w, act).float()
        assert bool(((got - want).abs() <= tg.DUAL_BF16_ATOL
                     + tg.DUAL_BF16_RTOL * want.abs()).all())
        assert torch.equal(ops.gated_mlp(x, *w, act).float(), got)

    @pytest.mark.parametrize("m", [13, 100])
    @pytest.mark.parametrize("group", [32, 64, 128])
    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_dual_int4_gemm_gated(self, rng, cuda_dev, act, group, m):
        """Decode (M = 13) and prefill (M = 100: 32-row blocks) shapes at
        every scale group."""
        sc = SILU if act == "silu" else GELU
        xq, xs, up, gate = dual_inputs(rng, m, 256, 72, group)
        args = ([T(xq).to(cuda_dev), T(xs).to(cuda_dev)]
                + [T(a).to(cuda_dev) for a in (*up, *gate)])
        assert torch.equal(ops.gated_mlp_w4a8(*args, act=act, act_scale=sc),
                           tg.gated_mlp_w4a8_ref(*args, act=act, act_scale=sc))


@pytest.mark.cuda
def test_decode_rows_on_card(rng, cuda_dev):
    """The multi-row form on the card: each row bit-equal to a T = 1 launch
    at its position with the same B, and close to the plain version."""
    inputs = TestDecodeAttentionRows()._rows(rng, t=20)
    qr, *rest, qp = [(_t_q(a) if i == 0 else T(a)).to(cuda_dev)
                     for i, a in enumerate(inputs)]
    got = ops.decode_attention_int8kv_rows(qr, *rest, qp)
    for i in range(qr.shape[1]):
        one = ops.decode_attention_int8kv(qr[:, i].contiguous(), *rest,
                                          qp[:, i].contiguous())
        assert torch.equal(got[:, i], one)
    torch.testing.assert_close(
        got.float(), int8_kv_decode_attention_rows_ref(qr, *rest, qp).float(),
        rtol=RTOL, atol=ATOL)
