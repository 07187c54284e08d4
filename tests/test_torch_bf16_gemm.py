"""The kernel the port adds beyond the TPU's, on the CPU: the bf16 float
linear (``kernels/bf16_gemm.py``).  Its plain version equals the models'
arithmetic (``layers.linear``) bit for bit; the models' bf16 linears
reach it and the f32 ones do not; its Function launches once and
differentiates as autograd of ``torch.matmul``; the wrapper refuses inputs
on two devices and operands the kernel does not take.  The kernel itself
runs only on the card (``chip_smoke.py`` phase 3)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bf16_gemm as bg
from repro_torch.kernels import common, ops
from repro_torch.models import layers
from repro_torch.models.layers import ExecMode, Linear

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
