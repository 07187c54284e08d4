"""Host-side rules of the redesigned int8_conv2d (B15) and int_softmax (B13)
kernels, on the CPU (the plain versions' parity with the JAX reference and
its Pallas kernels is in ``test_torch_int_library.py`` and
``test_torch_no_cache.py``):

* int8_conv2d: the block shapes ``conv2d.tiling`` picks and the ones
  ``csrc/int8_conv2d.cu`` instantiates, each within a block's shared memory;
  the gathered A stage's index map (``conv2d.a_offsets``, the kernel's
  walk written out) against ``x.unfold`` patches; the grid check; the
  alignment flags the C entry receives;
* int_softmax: the form ``int_softmax.form`` picks for each row length and
  the rows each form holds; the mask row rule (row r reads mask row r % R)
  against ``expand`` for every broadcast ``ops.softmax_i8`` passes uncopied,
  and the materialized path for those it does not; the mask reaching the C
  entry without a copy; the range checks; the reciprocals' 32-bit device
  form against floor division;
* no fallback: a CUDA tensor reaches the build (here it raises), never the
  plain version;
* on a card (``cuda``-marked, skipped here): the long-row form and the
  broadcast mask against the plain version.

This file imports no JAX, so its ``cuda`` tests run on the card's machine.
"""
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.core.inumerics import RequantParams
from repro_torch.kernels import build, ops
from repro_torch.kernels import conv2d as cv
from repro_torch.kernels import int8_gemm as tg
from repro_torch.kernels import int_softmax as sm
from repro_torch.kernels.common import LAUNCHES, rcp

# TestConv2d's shapes (n, h, w, c, kh, kw, o), then chip_smoke's phase 3
# shapes cut to a few images
CONV_SHAPES = [(1, 20, 18, 3, 3, 3, 8), (2, 9, 9, 16, 3, 3, 12),
               (2, 4, 4, 48, 1, 1, 20), (1, 7, 6, 5, 2, 3, 7),
               (1, 12, 11, 64, 3, 3, 64), (2, 14, 14, 768, 1, 1, 16),
               (1, 30, 30, 3, 3, 3, 64)]


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
# int8_conv2d
# ---------------------------------------------------------------------------

def _conv_cfgs():
    """(BM, BN, threads, blocks an SM) of every ``Cfg`` int8_conv2d.cu
    launches: its own ``Cfg<...>`` and the ones it takes from gemm_mma.cuh."""
    csrc = build.CSRC
    src = (csrc / "int8_conv2d.cu").read_text()
    lib = (csrc / "gemm_mma.cuh").read_text()

    def cfg(wm, wn, mt, np_, mb):
        return (16 * int(mt) * int(wm), 16 * int(np_) * int(wn),
                32 * int(wm) * int(wn), int(mb or 1))
    named = {n: cfg(*a) for n, *a in re.findall(
        r"using (\w+) = Cfg<(\d+), (\d+), (\d+), (\d+)(?:, (\d+))?>;", lib)}
    out = set()
    for name, rhs in re.findall(r"using (\w+) = mma_gemm::(\w+(?:<[^;]*>)?);", src):
        m = re.fullmatch(r"Cfg<(\d+), (\d+), (\d+), (\d+)(?:, (\d+))?>", rhs)
        out.add(cfg(*m.groups()) if m else named[rhs])
    return out


def test_conv_configs_mirror_the_source_and_fit():
    cfgs = _conv_cfgs()
    assert {(bm, bn, th) for bm, bn, th, _ in cfgs} == {
        (bm, bn, th) for (bm, bn), th in cv.CONFIGS.items()}
    for bm, bn, _, blocks in cfgs:
        smem = tg.mma_smem_bytes("w8", bm, bn, 1)
        assert smem <= tg.SMEM_PER_BLOCK
        assert blocks * (smem + 1024) <= tg.SMEM_PER_SM


@pytest.mark.parametrize("o,want", [(1, (64, 16)), (8, (64, 16)),
                                    (16, (64, 16)), (17, (128, 64)),
                                    (64, (128, 64)), (65, (96, 128)),
                                    (768, (96, 128))])
def test_conv_tiling_rule(o, want):
    for m in (1, 15876, 23328, 6272, 394272):
        assert cv.tiling(m, o) == want
        assert want in cv.CONFIGS


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_index_map_matches_unfold(shape):
    """The gathered A stage reads, for pixel m and depth k = (i*KW + j)*C +
    c, the byte of the window that ``x.unfold`` puts there."""
    n, h, w, c, kh, kw, _ = shape
    x = torch.randint(-128, 128, (n, h, w, c), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1))
    got = x.flatten()[cv.a_offsets(n, h, w, c, kh, kw)]
    patches = x.unfold(1, kh, 1).unfold(2, kw, 1)    # n, oh, ow, c, kh, kw
    want = patches.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
@pytest.mark.parametrize("requant", [False, True])
def test_conv_entry_arguments(monkeypatch, shape, requant):
    """The C entry gets the rule's block shape and the alignment flags:
    16-byte window chunks only where C % 16 == 0, weight chunks where
    O % 16 == 0, 4-column stores where O % 4 == 0."""
    n, h, w, c, kh, kw, o = shape
    seen = {}
    _fake_card(monkeypatch, cv, seen)
    x = torch.zeros((n, h, w, c), dtype=torch.int8)
    wt = torch.zeros((kh, kw, c, o), dtype=torch.int8)
    rq = RequantParams(s1=2, mult=9000, s2=14) if requant else None
    out = ops.conv2d_i8(x, wt, torch.zeros(o, dtype=torch.int32), rq)
    assert out.dtype == (torch.int8 if requant else torch.int32)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"]) == 21
    m = n * (h - kh + 1) * (w - kw + 1)
    assert args[11:20] == (int(requant), *((2, 9000, 14) if requant
                                           else (0, 0, 0)),
                           *cv.tiling(m, o), int(c % 16 == 0),
                           int(o % 16 == 0), int(o % 4 == 0))


def test_conv_grid_is_checked(monkeypatch):
    """Output pixels run along the grid's y: past 65535 blocks of the
    rule's rows the wrapper raises before it launches."""
    seen = {}
    _fake_card(monkeypatch, cv, seen)
    bm = cv.tiling(0, 128)[0]
    x = torch.zeros((1, 1, 65535 * bm + 1, 1), dtype=torch.int8)
    w = torch.zeros((1, 1, 1, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="exceed the grid"):
        ops.conv2d_i8(x, w, torch.zeros(128, dtype=torch.int32))
    assert "args" not in seen
    with pytest.raises(ValueError, match="overflows the int32 sums"):
        ops.conv2d_i8(torch.zeros((1, 4, 4, 32768), dtype=torch.int8),
                      torch.zeros((2, 2, 32768, 4), dtype=torch.int8),
                      torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# int_softmax
# ---------------------------------------------------------------------------

def _capacity(form: int) -> int:
    """Values a row of ``form`` holds in registers: lanes x 16-value groups
    (1 for form 0, else 2) x warps."""
    return 32 * 16 * (1 if form == 0 else 2) * max(form, 1)


@pytest.mark.parametrize("n", [1, 8, 15, 16, 300, 512, 513, 1000, 1024, 1025,
                               2048, 2049, 4096, 4097, 8192, 8193, 65536,
                               2 ** 17])
def test_softmax_form_by_row_length(n):
    f = sm.form(n)
    if n > sm.ROW_LIMIT:
        assert f == sm.LONG
        return
    assert f in (0, 1, 2, 4, 8)
    assert _capacity(f) >= n
    # the smallest form that holds the row (a warp a row up to 1024)
    assert f == 0 or _capacity(f // 2 if f > 1 else 0) < n


# (x shape, mask shape): broadcasts over leading dimensions only
ADMITTED = [((6, 16), (6, 16)), ((3, 8, 16), (8, 16)),
            ((3, 8, 16), (1, 8, 16)), ((2, 3, 8, 16), (8, 16)),
            ((2, 3, 8, 16), (1, 1, 8, 16)), ((2, 3, 8, 16), (2, 3, 8, 16))]
MATERIALIZED = [((3, 8, 16), (16,)), ((3, 8, 16), (1, 16)),
                ((3, 8, 16), (3, 1, 16)), ((2, 3, 8, 16), (2, 1, 8, 16)),
                ((2, 3, 8, 16), (3, 8, 16))]


def _mask(shape, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)) > 0.3


@pytest.mark.parametrize("xs,ms", ADMITTED, ids=str)
def test_softmax_mask_row_rule_matches_expand(xs, ms):
    """Row r of the flattened x reads mask row r % R of the uncopied
    [R, N] mask: the same keep bits as ``expand``, and the same
    probabilities from the plain version either way."""
    assert ops.softmax_mask_rows(xs, ms)
    mask = _mask(ms)
    n = xs[-1]
    rows = mask.reshape(-1, n)
    full = mask.expand(xs).reshape(-1, n)
    r = torch.arange(full.shape[0])
    assert torch.equal(rows[r % rows.shape[0]], full)
    x = torch.randint(-3000, 3000, xs, dtype=torch.int32,
                      generator=torch.Generator().manual_seed(2))
    want = sm.int_softmax_ref(x.reshape(-1, n), 0.01, full)
    assert torch.equal(sm.int_softmax_ref(x.reshape(-1, n), 0.01, rows), want)
    assert torch.equal(ops.softmax_i8(x, 0.01, mask).reshape(-1, n), want)


@pytest.mark.parametrize("xs,ms", MATERIALIZED, ids=str)
def test_softmax_other_broadcasts_are_materialized(xs, ms):
    assert not ops.softmax_mask_rows(xs, ms)
    mask = _mask(ms)
    x = torch.randint(-3000, 3000, xs, dtype=torch.int32,
                      generator=torch.Generator().manual_seed(3))
    n = xs[-1]
    want = sm.int_softmax_ref(x.reshape(-1, n), 0.01,
                              mask.expand(xs).reshape(-1, n))
    assert torch.equal(ops.softmax_i8(x, 0.01, mask).reshape(-1, n), want)


def test_softmax_mask_reaches_the_entry_uncopied(monkeypatch):
    """A bool [T, N] mask broadcast over [B, T, N] scores reaches the C
    entry as it is (its own storage, R = T rows); an int8 mask is
    converted to bool bytes first."""
    seen = {}
    _fake_card(monkeypatch, sm, seen)
    x = torch.zeros((4, 32, 32), dtype=torch.int32)
    keep = torch.ones((32, 32), dtype=torch.bool).tril()
    ops.softmax_i8(x, 0.01, keep)
    args = seen["args"]
    assert len(args) == len(seen["argtypes"]) == 18
    assert args[2] == keep.data_ptr() and args[3] == 32
    assert args[4:6] == rcp(32)
    assert args[7:9] == (128, 32)
    ops.softmax_i8(x, 0.01, keep.to(torch.int8))
    assert seen["args"][2] not in (0, keep.data_ptr())
    ops.softmax_i8(x, 0.01)
    assert seen["args"][2] == 0 and seen["args"][3] == 128


@pytest.mark.parametrize("n", [8, 1000, 1024, 4096, 8193, 2 ** 17])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_softmax_entry_arguments(monkeypatch, n, dtype):
    """q_ln2's reciprocal, the form of the row length and the vector flag
    (rows of a multiple of 16 values) reach the C entry; one launch a
    call, whichever form."""
    seen = {}
    _fake_card(monkeypatch, sm, seen)
    scale = 0.01
    before = LAUNCHES["int_softmax"]
    sm.int_softmax(torch.zeros((3, n), dtype=dtype), scale)
    assert LAUNCHES["int_softmax"] == before + 1
    q_ln2, q_b, q_c, es = sm._exp_consts(scale)
    args = seen["args"]
    assert args[1] == int(dtype == torch.int32)
    assert args[9:17] == (q_ln2, q_b, q_c, es, *rcp(q_ln2), sm.form(n),
                          int(n % 16 == 0))


def test_softmax_ranges_are_checked(monkeypatch):
    _fake_card(monkeypatch, sm, {})
    with pytest.raises(ValueError, match="2\\^17"):
        sm.int_softmax(torch.zeros((1, 2 ** 17 + 1), dtype=torch.int32), 0.01)
    with pytest.raises(ValueError, match="too fine"):
        sm.int_softmax(torch.zeros((1, 16), dtype=torch.int32), 1e-6)
    with pytest.raises(ValueError, match="R dividing"):
        sm.int_softmax(torch.zeros((6, 16), dtype=torch.int32), 0.01,
                       torch.ones((4, 16), dtype=torch.bool))
    # e * 127 + l // 2 < 2^31 at the longest rows, at every score scale the
    # integer attention uses
    from repro_torch.models.attention import int_score_scale
    for d in (16, 64, 80, 128):
        e = sm.exp_max(int_score_scale(d))
        assert e < 2 ** 14 and 127 * e + (sm.MAX_N * e) // 2 < 2 ** 31


def _div_rcp_device(n, m, sh):
    """``int_exp.cuh`` ``div_rcp``: the high word of the 32 x 32 product
    (2n) * m, shifted by sh - 31."""
    n = np.asarray(n, dtype=np.uint64)
    return (((n << np.uint64(1)) * np.uint64(m)) >> np.uint64(32)) \
        >> np.uint64(sh - 31)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 127, 128, 129, 1000, 12345,
                               2 ** 14, 2 ** 14 + 1, 2 ** 24 - 1, 2 ** 30 + 1,
                               2 ** 31 - 1])
def test_device_reciprocal_form_matches_floor_division(d):
    m, sh = rcp(d)
    rng = np.random.default_rng(d)
    top = 2 ** 31 - 1
    n = np.concatenate([rng.integers(0, 2 ** 31, 4096),
                        [0, 1, d - 1, d, d + 1, top, top - top % d,
                         top - top % d - 1]]).astype(np.uint64)
    assert np.array_equal(_div_rcp_device(n, m, sh), n // np.uint64(d))


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def _calls():
    from repro_torch.models.frontend import conv_patch_embed_int8
    img = torch.zeros((1, 5, 5, 3), dtype=torch.int8)
    filt = torch.zeros((3, 3, 3, 4), dtype=torch.int8)
    bias = torch.zeros(4, dtype=torch.int32)
    x = torch.zeros((2, 16, 16), dtype=torch.int32)
    keep = torch.ones((16, 16), dtype=torch.bool).tril()
    return [(cv, lambda: ops.conv2d_i8(img, filt, bias)),
            (cv, lambda: conv_patch_embed_int8(
                None, torch.zeros((1, 32, 32, 3)), 8, 16,
                weight=torch.ones((1, 1, 768, 8)))),
            (sm, lambda: ops.softmax_i8(x, 0.01, keep)),
            (sm, lambda: ops.softmax_i8(torch.zeros((1, 9000),
                                                    dtype=torch.int8), 0.05))]


@pytest.mark.parametrize("which", range(4))
def test_conv_and_softmax_never_fall_back(monkeypatch, which):
    """With the tensors taken for CUDA ones, ``ops.conv2d_i8``, the patch
    embed, a broadcast-mask softmax and a long-row softmax go to their
    kernels — here the build, which raises — never to the plain versions."""
    mod, call = _calls()[which]
    monkeypatch.setattr(mod, "on_cuda", lambda *a: True)
    monkeypatch.setattr(mod, "int8_conv2d_ref" if mod is cv
                        else "int_softmax_ref", None)
    _no_build(monkeypatch)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        call()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the "
                    "card (chip_smoke.py covers them there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8193, 50000, 2 ** 17])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_long_rows_on_card(cuda_dev, n, dtype):
    """The long-row form (a block per row, streamed) against the plain
    version, with a mask and without, rows of a multiple of 16 and not."""
    g = torch.Generator().manual_seed(n)
    hi = 128 if dtype == torch.int8 else 4000
    x = torch.randint(-hi, hi, (3, n), generator=g).to(dtype).to(cuda_dev)
    keep = (torch.rand((3, n), generator=g) > 0.5).to(cuda_dev)
    assert sm.form(n) == sm.LONG
    for mask in (None, keep):
        assert torch.equal(sm.int_softmax(x, 0.05, mask),
                           sm.int_softmax_ref(x, 0.05, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 300, 1024])
def test_broadcast_mask_on_card(cuda_dev, t):
    """A [T, T] causal keep mask over [B, T, T] scores, passed uncopied,
    against the plain version over the expanded mask."""
    g = torch.Generator().manual_seed(t)
    x = torch.randint(-4000, 4000, (3, t, t), generator=g,
                      dtype=torch.int32).to(cuda_dev)
    keep = torch.ones((t, t), dtype=torch.bool, device=cuda_dev).tril()
    got = ops.softmax_i8(x, 0.01, keep)
    want = sm.int_softmax_ref(x.reshape(-1, t), 0.01,
                              keep.expand(3, t, t).reshape(-1, t))
    assert torch.equal(got.reshape(-1, t), want)
