"""Training xlstm-350m, llama-3.2-vision-90b (``lm_loss`` with
``kv_source``, the cross layer's gates nonzero, per element in the
gradient check) and whisper-small
(``encdec_loss``) in the port, on the CPU, against the JAX reference: the
checks of ``tests/test_torch_train_archs.py`` (gradients per leaf, remat on
= off, AdamW bit-exact on each tree), and the serving callers of the now
differentiable ``encode``: the whisper launcher's tokens equal with grad
on and off, and ``encode`` over parameters that require grad gives the
same bits under ``no_grad`` as with a graph.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import encode

from test_torch_train_archs import (ENCDEC, _inputs, check_adamw,
                                    check_gradients, check_remat,
                                    reference_grads)

ARCHS = (("xlstm-350m", 0), ("llama-3.2-vision-90b", 0), (ENCDEC, 0))


@pytest.fixture(scope="module", params=ARCHS, ids=[a for a, _ in ARCHS])
def graded(request):
    return reference_grads(*request.param)


def test_gradients_match_the_reference(graded):
    check_gradients(graded)


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
def test_remat_gives_equal_gradients(arch):
    check_remat(arch)


def test_adamw_bit_exact(graded):
    check_adamw(graded)


def test_serving_callers_keep_their_results(monkeypatch):
    """``launch/serve.py --arch whisper-small --reduced --device cpu``
    serves the same tokens with grad mode on (the default) and under
    ``torch.no_grad``; ``encode`` over parameters that require grad gives
    the same bits under ``torch.no_grad`` as with a graph."""
    from repro_torch.launch import serve
    from repro_torch.models import init_encdec_params
    served = []
    drained = serve.ServingEngine.run_until_drained

    def recording(self):
        done = drained(self)
        served.append(sorted((d["id"], tuple(d["tokens"]))
                             for d in done))
        return done
    monkeypatch.setattr(serve.ServingEngine, "run_until_drained", recording)
    argv = ["--arch", ENCDEC, "--reduced", "--w8a8", "--int8-kv",
            "--requests", "3", "--max-new", "4", "--device", "cpu"]
    serve.main(argv)
    with torch.no_grad():
        serve.main(argv)
    assert len(served) == 2 and served[0] == served[1]
    assert [len(t) for _, t in served[0]] == [4] * 3
    cfg = get_config(ENCDEC, reduced=True)
    params = init_encdec_params(cfg, seed=0, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    frames = torch.from_numpy(_inputs(cfg, 0)[2])
    with torch.no_grad():
        quiet = encode(params, cfg, frames)
    graph = encode(params, cfg, frames)
    assert quiet.grad_fn is None and graph.grad_fn is not None
    assert torch.equal(quiet, graph.detach())
