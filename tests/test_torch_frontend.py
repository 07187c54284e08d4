"""The port's modality frontend (``repro_torch.models.frontend``) against the
reference's, on the CPU.  ``conv_patch_embed_int8`` is given the weight the
reference draws (``jax.random.normal``) and the same images, made with numpy;
the int8 image, the int8 weight and the output must agree bit for bit (the
reference runs the function eagerly, so its divisions are true divisions,
and the conv is exact), with the reference's conv on its jnp path and on
its Pallas kernel in interpret mode.  The stubs are checked for shape,
scale and determinism (``torch.Generator`` and ``jax.random`` draw different
numbers from one seed).
"""
import numpy as np
import jax
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.common import set_interpret
from repro.models import frontend as jfrontend

from repro_torch.kernels import ops
from repro_torch.models import frontend


def _capture(monkeypatch, module, store):
    """Record the int8 operands each side hands its conv."""
    conv = module.conv2d_i8

    def spy(x, w, bias, requant_params=None):
        store.append((np.asarray(x), np.asarray(w)))
        return conv(x, w, bias, requant_params)
    monkeypatch.setattr(module, "conv2d_i8", spy)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("b,side,patch,d", [(2, 32, 16, 64), (1, 24, 8, 48)])
def test_patch_embed_bit_exact_vs_reference(monkeypatch, backend, b, side,
                                            patch, d):
    set_interpret(True)
    jops.set_backend(backend)
    try:
        rng = np.random.default_rng(b * side + d)
        images = rng.uniform(-1, 1, (b, side, side, 3)).astype(np.float32)
        images[0, 0, 0, :] = [1.0, -1.0, 0.5 / 127]     # extremes, a tie
        key = jax.random.PRNGKey(7)
        jw = np.array(jax.random.normal(key, (1, 1, patch * patch * 3, d)))
        theirs, ours = [], []
        _capture(monkeypatch, jops, theirs)
        _capture(monkeypatch, ops, ours)
        want = np.asarray(jfrontend.conv_patch_embed_int8(key, images, d,
                                                          patch=patch))
        got = frontend.conv_patch_embed_int8(
            None, torch.from_numpy(images), d, patch=patch,
            weight=torch.from_numpy(jw))
    finally:
        jops.set_backend("jnp")
    (jx, jwi), = theirs
    (tx, twi), = ours
    assert tx.dtype == np.int8 and np.array_equal(tx, jx)
    assert twi.dtype == np.int8 and np.array_equal(twi, jwi)
    assert got.shape == (b, (side // patch) ** 2, d)
    assert np.array_equal(got.numpy(), want)


def test_patch_embed_draws_from_the_generator():
    images = torch.rand((1, 16, 16, 3), generator=torch.Generator()
                        .manual_seed(0)) * 2 - 1
    a = frontend.conv_patch_embed_int8(torch.Generator().manual_seed(3),
                                       images, 32, patch=8)
    b = frontend.conv_patch_embed_int8(torch.Generator().manual_seed(3),
                                       images, 32, patch=8)
    c = frontend.conv_patch_embed_int8(torch.Generator().manual_seed(4),
                                       images, 32, patch=8)
    assert a.shape == (1, 4, 32) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="patches"):
        frontend.conv_patch_embed_int8(None, images[:, :12], 32, patch=8)
    with pytest.raises(ValueError, match="weight"):
        frontend.conv_patch_embed_int8(None, images, 32, patch=8,
                                       weight=torch.zeros(1, 1, 3, 32))


@pytest.mark.parametrize("stub,ref", [
    (frontend.audio_frames_stub, jfrontend.audio_frames_stub),
    (frontend.vision_tokens_stub, jfrontend.vision_tokens_stub)])
def test_stubs(monkeypatch, stub, ref):
    out = stub(torch.Generator().manual_seed(0), 2, 50, 64, device="cpu")
    want = np.asarray(ref(jax.random.PRNGKey(0), 2, 50, 64))
    assert out.shape == want.shape and out.dtype == torch.float32
    # the same distribution: N(0, 0.02^2)
    assert abs(float(out.std()) - 0.02) < 0.002
    assert abs(float(want.std()) - 0.02) < 0.002
    again = stub(torch.Generator().manual_seed(0), 2, 50, 64, device="cpu")
    assert torch.equal(out, again)
    # an entry point: the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stub(torch.Generator().manual_seed(0), 1, 2, 4)
