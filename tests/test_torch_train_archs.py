"""Training the other served archs in the port, on the CPU, against the JAX
reference: zamba2-2.7b, mixtral-8x7b and qwen2-moe-a2.7b here, xlstm-350m,
llama-3.2-vision-90b (``lm_loss`` with ``kv_source``) and whisper-small
(``encdec_loss``) in ``tests/test_torch_train_cross.py`` (two files, so
that the workers spread them), each at its reduced config with the
reference's own weights (``convert.py``) and numpy-seeded inputs.

* Gradients against ``jax.value_and_grad`` compiled with
  ``xla_allow_excess_precision`` off (``EXACT``): the loss within
  ``LOSS_RTOL``; every leaf of the gradient tree within relative L2
  ``GRAD_REL_L2`` (tests/test_torch_train.py's bound) — except a leaf that
  the reference itself does not fix to that bound: where its two
  compilations (excess precision off and on) differ on the leaf by more
  than ``GRAD_REL_L2``, the port's error on it must stay within that
  difference, both relative to the leaf's own norm.  Measured at these
  seeds: every leaf of mixtral, qwen2-moe, xlstm, vision and whisper within
  2.4%; zamba2's Mamba-2 vectors (A_log, D, dt_bias: reductions over every
  token of bf16-rounded products) up to 4.6% where the reference's own
  settings differ by 10.7-13.9% on the same leaves.
* vision's gradient tree holds the cross layer's gates per element, at the
  stream's shape (``GATES`` broadcast over B x T x d): the same loss, whose
  gate gradients are then the terms that a scalar gate's gradient sums.
  That sum is ill-conditioned at these inputs (gate_attn's 4096 terms sum
  to 2600x less than their magnitudes), so a scalar gate's gradient is
  decided by bf16 rounding; each term is held to ``GRAD_REL_L2`` like any
  other leaf (0.7% at seed 0).  AdamW takes the scalar gates.
* MoE: the reference compiled as above, and seeds without a bf16 router
  near-tie (ROADMAP C12): the gradient check asserts that no token's k-th
  and (k+1)-th router probabilities lie within ``NEAR_TIE`` in any layer.
* Remat on and off give equal gradients (``torch.equal``): the decoders'
  layers and whisper's encoder blocks under ``torch.utils.checkpoint``.
* AdamW on each tree bit-exact against the reference's jitted
  ``adamw_update`` over two steps below the clip (decay by the reference's
  leaf rank, ``convert.reference_ndims``, C19): the Mamba-2 vectors and
  the shared block, the stacked experts and router, the xLSTM cells, the
  ``xattn`` gates and the encoder-decoder tree.
* ``GRAD_KERNELS`` names exactly the wrappers that launch inside a
  ``torch.autograd.Function``; a bare ``"cuda"`` resolves to the current
  card's index (``launch/train.py``'s default).
"""
import ast
import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import encdec_loss as jencdec_loss
from repro.models import init_encdec_params as jinit_encdec
from repro.models import init_params as jinit_params
from repro.models import lm_loss as jlm_loss
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import optimizer as jopt

from repro_torch.configs import get_config
from repro_torch.convert import (from_reference, reference_ndims, to_reference,
                                 tree_to_reference)
from repro_torch.kernels import common
from repro_torch.models import encdec_loss, lm_loss
from repro_torch.models import moe as tmoe
from repro_torch.train import AdamWConfig, optimizer
from repro_torch.train.trainer import trained_params

EXACT = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 0.03
NEAR_TIE = 1e-3
GATES = (0.5, -0.7)
# (arch, seed): seed 0 for each; its MoE routing has no near-tie
ARCHS = (("zamba2-2.7b", 0), ("mixtral-8x7b", 0), ("qwen2-moe-a2.7b", 0))
ENCDEC = "whisper-small"
VISION = "llama-3.2-vision-90b"
B, T, FRAMES, SV = 2, 32, 64, 16


def _inputs(cfg, seed):
    """tokens, labels (B, T) int32 and the features: whisper's stub frames
    (B, FRAMES, d), vision's stub tokens (B, SV, d), both at the stub
    frontends' scale 0.02; None elsewhere."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    n = FRAMES if cfg.name.startswith(ENCDEC) else SV
    feats = (rng.normal(size=(B, n, cfg.d_model)) * 0.02).astype(np.float32)
    return tok, lab, (feats if cfg.is_encoder_decoder or cfg.family == "vlm"
                      else None)


def _reference_tree(arch, jcfg, seed, per_element: bool = False):
    """The reference's initial tree; vision's cross layer with its gates
    at ``GATES``, (1, 1) or (with ``per_element``) one value per element
    of the stream, (1, B, T, d)."""
    key = jax.random.PRNGKey(seed)
    if arch == ENCDEC:
        return jinit_encdec(key, jcfg)
    p = jinit_params(key, jcfg)
    if arch == VISION:
        shape = (1, B, T, jcfg.d_model) if per_element else (1, 1)
        per = list(p["periods"])
        per[4] = dict(per[4], **{k: jnp.full(shape, g, jnp.float32)
                                 for k, g in zip(("gate_attn", "gate_mlp"),
                                                 GATES)})
        p = dict(p, periods=per)
    return p


def _reference_loss(arch, jcfg, tok, lab, feats):
    if arch == ENCDEC:
        return lambda p: jencdec_loss(p, jcfg, feats, tok, lab)
    return lambda p: jlm_loss(p, jcfg, tok, lab, kv_source=feats)


def _port(tree, cfg):
    m = from_reference(tree, cfg, "cpu")
    for p in m.parameters():
        p.requires_grad_(p.is_floating_point())
    return m


def _port_loss(m, cfg, tok, lab, feats):
    t, l = torch.from_numpy(tok).long(), torch.from_numpy(lab).long()
    f = None if feats is None else torch.from_numpy(feats)
    if cfg.is_encoder_decoder:
        return encdec_loss(m, cfg, f, t, l)
    return lm_loss(m, cfg, t, l, kv_source=f)


def _port_grads(m, cfg, tok, lab, feats):
    named = trained_params(m)
    loss = _port_loss(m, cfg, tok, lab, feats)
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _router_gaps(run):
    """``run()`` under a recorder of the port's routing: (result, the
    smallest gap between any token's k-th and (k+1)-th router
    probabilities over every MoE layer, inf without one)."""
    gaps = []
    route = tmoe._route

    def recording(probs, k, capacity):
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return route(probs, k, capacity)
    tmoe._route = recording
    try:
        out = run()
    finally:
        tmoe._route = route
    return out, min(gaps, default=float("inf"))


def reference_grads(arch, seed):
    """(arch, seed, configs, numpy tree with vision's gates per element,
    inputs, reference loss and gradient leaves, the reference's loss
    function): ``value_and_grad`` compiled once."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tok, lab, feats = _inputs(cfg, seed)
    jp = _reference_tree(arch, jcfg, seed, per_element=True)
    fn = jax.value_and_grad(_reference_loss(arch, jcfg, tok, lab, feats))
    loss, grads = jax.jit(fn, compiler_options=EXACT)(jp)
    return dict(arch=arch, seed=seed, jcfg=jcfg, cfg=cfg, jp=jp,
                tree=jax.device_get(jp),
                inputs=(tok, lab, feats), loss=float(loss),
                grads=jax.tree_util.tree_flatten_with_path(
                    jax.device_get(grads))[0], fn=fn)


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64)))


@pytest.fixture(scope="module", params=ARCHS, ids=[a for a, _ in ARCHS])
def graded(request):
    return reference_grads(*request.param)


def check_gradients(graded):
    cfg = graded["cfg"]
    m = _port(graded["tree"], cfg)
    (loss, grads), gap = _router_gaps(
        lambda: _port_grads(m, cfg, *graded["inputs"]))
    if cfg.n_experts:
        assert gap >= NEAR_TIE, f"a bf16 router near-tie ({gap}): C12"
    jloss = graded["loss"]
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    got = jax.tree_util.tree_leaves(tree_to_reference(m, grads, cfg))
    want = graded["grads"]
    assert len(got) == len(want)
    over = {}
    for (path, a), b in zip(want, got):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape and np.isfinite(b).all(), name
        err = float(np.linalg.norm(a - b))
        if err > GRAD_REL_L2 * _norm(a):
            over[name] = (a, err)
    if not over:
        return
    # leaves past the bound: the reference must not fix them either, and
    # the port stays within the reference's own spread on them
    other = jax.tree_util.tree_leaves(jax.device_get(
        jax.jit(graded["fn"])(graded["jp"])[1]))
    spread = {jax.tree_util.keystr(p): _norm(np.asarray(a, np.float64)
                                             - np.asarray(c, np.float64))
              for (p, a), c in zip(want, other)}
    for name, (a, err) in over.items():
        rel, own = err / _norm(a), spread[name] / _norm(a)
        assert own > GRAD_REL_L2, (name, rel, own,
                                   "the reference fixes this leaf")
        assert rel <= own, (name, rel, "past the reference's own spread", own)


def test_gradients_match_the_reference(graded):
    check_gradients(graded)


def check_remat(arch):
    jcfg = jget_config(arch, reduced=True)
    tree = jax.device_get(_reference_tree(arch, jcfg, 1))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(arch, reduced=True), remat=remat)
        out.append(_port_grads(_port(tree, cfg), cfg, *_inputs(cfg, 1)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
def test_remat_gives_equal_gradients(arch):
    check_remat(arch)


def _tree_like(tree, rng, scale):
    return jax.tree.map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale).astype(np.float32),
        tree)


def _named_from_tree(tree, cfg):
    return {k: p.detach().clone() for k, p in
            from_reference(tree, cfg, "cpu").named_parameters()}


def check_adamw(graded):
    """Two updates below the clip from the converted tree and the same
    random gradient trees: parameters and both moments bit-equal to the
    reference's jitted ``adamw_update`` (the state passed in); vision's
    gates scalar, as the model holds them."""
    cfg = graded["cfg"]
    tree = jax.device_get(_reference_tree(graded["arch"], graded["jcfg"],
                                          graded["seed"]))
    rng = np.random.default_rng(3)
    gtrees = [_tree_like(tree, rng, 1e-4) for _ in range(2)]
    jc = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jc, p, g, s))
    jp, js = tree, jopt.init_opt_state(tree)
    m = from_reference(tree, cfg, "cpu")
    named = dict(m.named_parameters())
    ps = optimizer.init_opt_state(named)
    ndims = reference_ndims(m, cfg)
    assert ndims.keys() == named.keys()
    for g in gtrees:
        jp, js, met = upd(jp, g, js)
        assert float(met["grad_norm"]) < 1.0
        _, ps, _ = optimizer.adamw_update(
            AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4), named,
            _named_from_tree(g, cfg), ps, ndims)
        want = jax.device_get((jp, js.mu, js.nu))
        got = (to_reference(m, cfg), tree_to_reference(m, ps.mu, cfg),
               tree_to_reference(m, ps.nu, cfg))
        for wt, gt in zip(want, got):
            for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
                    wt)[0], jax.tree_util.tree_leaves(gt)):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (
                    jax.tree_util.keystr(path))


def test_adamw_bit_exact(graded):
    check_adamw(graded)


# ---------------------------------------------------------------------------
# the wrappers under autograd
# ---------------------------------------------------------------------------

def _function_wrappers() -> set[str]:
    """The functions of ``kernels/*.py`` that call ``<F>.apply`` of a
    ``torch.autograd.Function`` subclass defined in the same module."""
    out = set()
    root = pathlib.Path(common.__file__).parent
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        fns = {n.name for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               and any(ast.unparse(b).endswith("autograd.Function")
                       for b in n.bases)}
        for f in ast.walk(tree):
            if isinstance(f, ast.FunctionDef) and any(
                    isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute)
                    and c.func.attr == "apply"
                    and ast.unparse(c.func.value) in fns
                    for c in ast.walk(f)):
                out.add(f.name)
    return out


def test_grad_kernels_are_the_function_wrappers():
    assert _function_wrappers() == set(common.GRAD_KERNELS)


def test_a_bare_cuda_device_names_the_current_card(monkeypatch):
    """``device="cuda"`` (the launchers' default) resolves to the current
    card's index, so that ``Trainer`` finds the parameters ``init_params``
    put there on the device it was given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert common.resolve_device("cuda") == torch.device("cuda", 0)
    assert common.resolve_device(None) == torch.device("cuda", 0)
    assert common.resolve_device("cuda:0") == torch.device("cuda", 0)
