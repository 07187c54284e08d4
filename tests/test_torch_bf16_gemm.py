"""The kernel the port adds beyond the TPU's, on the CPU: the bf16 float
linear (``kernels/bf16_gemm.py``).  Its plain version equals the models'
arithmetic (``layers.linear``) bit for bit; the models' bf16 linears
reach it and the f32 ones do not; its Function launches once and
differentiates as autograd of ``torch.matmul``; the wrapper refuses inputs
on two devices and operands the kernel does not take.  The tiling rule
gives ``wgmma``-legal tiles over all of K (never a split) at the served
shapes and their tensor-parallel shards, enough blocks at decode rows to
cover the SMs, and the padding of a ragged K or N keeps the plain result
bit for bit.  The kernel itself runs only on the card (``chip_smoke.py``
phase 3, which also holds every tiling to the same bits)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune as at
from repro_torch.kernels import bf16_gemm as bg
from repro_torch.kernels import common, ops
from repro_torch.models import layers
from repro_torch.models.layers import ExecMode, Linear


@pytest.fixture(autouse=True)
def _table_only(monkeypatch, tmp_path):
    """The tilings are the table's: no measured cache of this machine."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    at.reset_measured_cache()
    yield
    at.reset_measured_cache()

BF16 = torch.bfloat16


def _rand(rng, *shape, dtype=BF16):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


@pytest.mark.parametrize("shape", [(8, 64, 48), (37, 96, 70), (2, 5, 32, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_version_is_layers_linear(shape, with_bias):
    rng = np.random.default_rng(len(shape) + with_bias)
    *lead, k, n = shape
    x = _rand(rng, *lead, k, dtype=torch.float32)
    w = _rand(rng, k, n)
    b = _rand(rng, n, dtype=torch.float32) if with_bias else None
    want = layers.linear(x, w, b, BF16)
    assert torch.equal(ops.gemm_bf16(x, w, b), want)
    if len(lead) == 1:
        assert torch.equal(bg.bf16_gemm_ref(x, w, b), want)
        assert torch.equal(bg.bf16_gemm(x.to(BF16), w, None if b is None
                                         else b.to(BF16)), want)


def _spy(monkeypatch):
    calls = []
    real = ops.gemm_bf16

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)
    monkeypatch.setattr(layers.ops, "gemm_bf16", spy)
    return calls


def test_apply_linear_sends_bf16_through_the_kernel(monkeypatch):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(3)
    x = _rand(rng, 4, 32)
    p = Linear(_rand(rng, 32, 16))
    b = _rand(rng, 16)
    res = _rand(rng, 4, 16)
    got = layers.apply_linear(x, p, ExecMode("bf16"), bias=b, residual=res)
    assert calls == [(32, 16)]
    assert torch.equal(got, layers.linear(x, p.weight, b, BF16) + res)
    # an f32 compute dtype (the f32 head, whisper's f32 products) stays
    # torch.matmul
    f32 = layers.apply_linear(x.float(), Linear(p.weight.float()),
                              ExecMode("bf16", torch.float32))
    assert calls == [(32, 16)]
    assert torch.equal(f32, x.float() @ p.weight.float())


def _emulate(monkeypatch):
    """Take the inputs for CUDA ones and the launch for the plain version
    plus a count (the kernel runs only on the card)."""
    monkeypatch.setattr(bg, "on_cuda", lambda *a: True)

    def launch(*a):
        common.LAUNCHES["bf16_gemm"] += 1
        return bg.bf16_gemm_ref(*a)
    monkeypatch.setattr(bg, "_launch", launch)


@pytest.mark.parametrize("with_bias", [False, True])
def test_gemm_function_gradients_are_matmuls(monkeypatch, with_bias):
    """Under autograd the kernel launches once in the forward and never in
    the backward, and the input, weight (and bias) gradients equal
    autograd of ``torch.matmul`` (+ bias) bit for bit."""
    _emulate(monkeypatch)
    rng = np.random.default_rng(11)
    ins = [_rand(rng, 24, 32), _rand(rng, 32, 40)]
    if with_bias:
        ins.append(_rand(rng, 40))
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    out = bg.bf16_gemm(*leaves)
    dout = _rand(rng, 24, 40)
    got = torch.autograd.grad(out, leaves, dout)
    assert ops.launch_counts()["bf16_gemm"] == 1
    ref = [t.clone().requires_grad_() for t in ins]
    want_out = torch.matmul(ref[0], ref[1])
    if with_bias:
        want_out = want_out + ref[2]
    want = torch.autograd.grad(want_out, ref, dout)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a weight that needs no gradient gets none
    leaves[1].requires_grad_(False)
    assert torch.autograd.grad(bg.bf16_gemm(*leaves), leaves[0],
                               dout)[0] is not None


def test_wrapper_refuses_mixed_devices():
    x = torch.zeros(4, 8, dtype=BF16)
    w_meta = torch.zeros(8, 4, dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="span devices"):
        bg.bf16_gemm(x, w_meta)
    with pytest.raises(ValueError, match="span devices"):
        bg.bf16_gemm(x, torch.zeros(8, 4, dtype=BF16),
                     torch.zeros(4, dtype=BF16, device="meta"))


def test_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On the card (the launch's build replaced by a failure) the wrapper
    raises on operands the kernel does not take, before any build."""
    from repro_torch.kernels import build

    def no_build(*a):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)
    monkeypatch.setattr(bg, "on_cuda", lambda *a: True)
    x = torch.zeros(4, 8, dtype=BF16)
    with pytest.raises(ValueError, match="contiguous bf16"):
        bg.bf16_gemm(x, torch.zeros(8, 4))              # an f32 weight
    with pytest.raises(ValueError, match="contiguous bf16"):
        bg.bf16_gemm(x, torch.zeros(4, 8, dtype=BF16).T)
    with pytest.raises(ValueError, match="bias must be"):
        bg.bf16_gemm(x, torch.zeros(8, 4, dtype=BF16),
                     torch.zeros(5, dtype=BF16))
    with pytest.raises(RuntimeError, match="no nvcc here"):
        bg.bf16_gemm(x, torch.zeros(8, 4, dtype=BF16))


# the bf16 models' float linears (chip_smoke's BF16_GEMMS): (K, N, TP form),
# "cols" sharded by columns (N / tp), "rows" run on M / tp rows
SERVED = ((4096, 4096, "cols"), (4096, 4096, "rows"), (13440, 4096, "rows"),
          (3072, 3072, "cols"), (3072, 256, "cols"), (3072, 3072, "rows"),
          (3072, 12288, "cols"), (12288, 3072, "rows"))
ROWS = (2, 4, 8, 64, 256, 4096)
H100_SMS = 132


def _launches(k, n, form):
    """(m, n) of the unsharded launch and of its tp 2 and tp 4 shards."""
    for m in ROWS:
        yield m, n
        for tp in (2, 4):
            yield (m, n // tp) if form == "cols" else (max(m // tp, 1), n)


@pytest.mark.parametrize("k,n,form", SERVED,
                         ids=lambda v: str(v))
def test_tiling_is_wgmma_legal_and_never_splits_k(k, n, form):
    """Every launch of the served shapes (and of their shards) gets a tile
    the C entry takes: 64-row warpgroups, a ``wgmma`` width (a multiple of
    8 up to 256), each block over all of K, the blocks covering M x N."""
    for m, nn in _launches(k, n, form):
        t = at.bf16_gemm_blocks(m, k, nn, H100_SMS)
        assert t[:4] in at.BF16_GEMM_TILINGS
        assert t.bm % 64 == 0 and t.bn % 8 == 0 and 8 <= t.bn <= 256
        assert t.k_len == k
        assert t.blocks == common.cdiv(m, t.bm) * common.cdiv(nn, t.bn)
        assert m <= t.x_rows or t.x_rows == t.bm
        assert t in at.bf16_gemm_candidates(m, k, nn)


@pytest.mark.parametrize("k,n,form", SERVED, ids=lambda v: str(v))
def test_decode_tiling_covers_the_sms(k, n, form):
    """At decode rows the blocks alone fill the card without a split of K:
    at least 96 of them where N >= 3072, each keeping INFLIGHT bytes of
    weight in flight."""
    for m, nn in _launches(k, n, form):
        if m > at.BF16_DECODE_M:
            continue
        t = at.bf16_gemm_blocks(m, k, nn, H100_SMS)
        if nn >= 3072:
            assert t.blocks >= 96
        assert (t.stages - 1) * at.BF16_BK * t.bn * 2 >= at.BF16_INFLIGHT


def test_tilings_offered_by_rows():
    """The 8-row stages take M <= 8 only; every other tiling takes any M."""
    assert (len(at.bf16_gemm_candidates(8, 4096, 4096))
            == len(at.BF16_GEMM_TILINGS))
    wide = at.bf16_gemm_candidates(9, 4096, 4096)
    assert [t[:4] for t in wide] == [t for t in at.BF16_GEMM_TILINGS
                                     if t[3] == t[0]]


@pytest.mark.parametrize("m,k,n", [(8, 770, 96), (5, 13, 27), (37, 64, 51),
                                   (64, 1003, 130), (3, 4, 8)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("with_bias", [False, True])
def test_padding_keeps_the_plain_result(m, k, n, with_bias):
    """A K or N that is not a multiple of 8 (or both) zero-padded as the
    wrapper pads it: the plain version's first N columns equal the unpadded
    plain result bit for bit."""
    rng = np.random.default_rng(m * 1000 + k + n + with_bias)
    x, w = _rand(rng, m, k), _rand(rng, k, n)
    b = _rand(rng, n) if with_bias else None
    xp, wp, bp = bg._pad(x, w, b)
    assert wp.shape[0] % 8 == 0 and wp.shape[1] % 8 == 0
    assert xp.shape == (m, wp.shape[0])
    got = bg.bf16_gemm_ref(xp, wp, bp)[:, :n]
    assert torch.equal(got, bg.bf16_gemm_ref(x, w, b))


def test_launch_hands_the_entry_padded_operands_and_the_rule(monkeypatch):
    """The launch (its C entry replaced by a recorder) passes the padded K
    and N, the rule's tiling or the one asked for, and returns [M, N]."""
    calls = []

    def entry(*a):
        def fn(*args):
            calls.append(args[3:9])
            return 0
        return fn
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "entry", entry)
    monkeypatch.setattr(bg, "_stream", lambda dev: 0)
    monkeypatch.setattr(bg, "_n_sm", lambda dev: H100_SMS)
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 8, 12), _rand(rng, 12, 30), _rand(rng, 30)
    out = bg._launch(x, w, b)
    assert out.shape == (8, 30) and out.is_contiguous()
    want = at.bf16_gemm_blocks(8, 16, 32, H100_SMS)
    assert calls[-1] == (8, 32, 16, want.bm, want.bn, want.stages)
    asked = at.bf16_gemm_candidates(8, 16, 32)[-1]
    bg._launch(x, w, None, asked)
    assert calls[-1] == (8, 32, 16, asked.bm, asked.bn, asked.stages)
