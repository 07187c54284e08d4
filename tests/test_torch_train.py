"""The port's training path on the CPU against the JAX reference
(``repro.train``, ``repro.dist.compression``, ``repro.models.moe``), at
reduced sizes with the reference's own weights (``convert.py``).

* ``lm_loss`` gradients of codeqwen1.5-7b-reduced and starcoder2-3b-reduced
  (2 x 32 tokens) against ``jax.value_and_grad`` compiled with
  ``xla_allow_excess_precision`` off (``EXACT``): the loss within
  ``LOSS_RTOL``, each leaf of the gradient tree — the qkv biases included —
  within relative L2 ``GRAD_REL_L2`` (measured 1.2-1.9%: the two sum bf16
  products in other orders, and the reference's own gradients move by up
  to 2.2% between XLA's two excess-precision settings).
* Remat on and off give equal gradients (``torch.equal``).
* AdamW: ``lr_schedule`` bit-equal over warmup and decay; ``global_norm``
  within ``GNORM_RTOL`` (f64 sums here, XLA's f32 order there);
  ``adamw_update`` over two steps from the same converted parameters,
  gradients and state bit-exact below the clip, and within ``CLIP_ULPS``
  ulps once the clip scales the gradients (it multiplies them by
  clip / gnorm, and gnorm differs in its last bits); decay on matrices only;
  zamba2-reduced's shared block (one ``Block`` at every ``shared_attn``
  position) updated once, as the reference updates ``params["shared"]``.
* Compression: payload and error state bit-exact; error feedback
  telescopes.
* ``moe_aux_loss`` at mixtral-reduced and qwen2-moe-reduced within
  ``AUX_RTOL`` (f32 sums in other orders).
* ``Trainer``: a 5-step trajectory against the reference ``Trainer`` (its
  own jit, default XLA flags) with losses within ``TRAJ_ATOL``;
  ``accum_steps`` 2 vs 1 within the reference's own bounds
  (``tests/test_system.py:98``); ``grad_compression``; the ``Watchdog`` as
  the reference's; the loss decreasing over 25 steps
  (``tests/test_system.py:66``); an integer precision refused.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.dist import compression as jcomp
from repro.models import init_params as jinit_params
from repro.models import lm_loss as jlm_loss
from repro.models import moe as jmoe
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import optimizer as jopt
from repro.train.trainer import Watchdog as JWatchdog

from repro_torch.configs import get_config
from repro_torch.convert import (from_reference, reference_ndims, to_reference,
                                 tree_to_reference)
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.dist import compression as comp
from repro_torch.models import lm_loss
from repro_torch.models import moe as tmoe
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, optimizer
from repro_torch.train.trainer import Watchdog, trained_params

EXACT = {"xla_allow_excess_precision": False}
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 0.03
GNORM_RTOL = 1e-6
CLIP_ULPS = 2
AUX_RTOL = 1e-5
TRAJ_ATOL = 2e-3
ARCHS = ("codeqwen1.5-7b", "starcoder2-3b")


def _tokens(cfg, seed, b=2, t=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32))


def _port(tree, cfg, grad=True):
    m = from_reference(tree, cfg, "cpu")
    for p in m.parameters():
        p.requires_grad_(grad)
    return m


def _port_grads(m, cfg, tok, lab):
    named = trained_params(m)
    loss = lm_loss(m, cfg, torch.from_numpy(tok).long(),
                   torch.from_numpy(lab).long())
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module", params=ARCHS)
def graded(request):
    """(arch, reference tree, tokens, labels, reference loss and gradient
    tree): the reference's ``value_and_grad`` compiled once per arch."""
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(0), jcfg))
    tok, lab = _tokens(jcfg, 0)
    f = jax.jit(jax.value_and_grad(lambda p: jlm_loss(p, jcfg, tok, lab)),
                compiler_options=EXACT)
    loss, grads = f(tree)
    return arch, tree, tok, lab, float(loss), jax.device_get(grads)


def test_lm_loss_gradients_match_the_reference(graded):
    arch, tree, tok, lab, jloss, jgrads = graded
    cfg = get_config(arch, reduced=True)
    m = _port(tree, cfg)
    loss, grads = _port_grads(m, cfg, tok, lab)
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    got = tree_to_reference(m, grads, cfg)
    want = _leaves(jgrads)
    names = [jax.tree_util.keystr(p) for p, _ in want]
    assert any("'bq'" in n for n in names), "the qkv biases are leaves"
    assert len(jax.tree_util.tree_leaves(got)) == len(want)
    for (path, a), b in zip(want, jax.tree_util.tree_leaves(got)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_gradients(arch):
    jcfg = jget_config(arch, reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(1), jcfg))
    tok, lab = _tokens(jcfg, 1)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(arch, reduced=True), remat=remat)
        out.append(_port_grads(_port(tree, cfg), cfg, tok, lab))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(3, 10), (100, 10_000), (0, 1)])
def test_lr_schedule_bit_equal(warmup, total):
    jc = JAdamWConfig(warmup_steps=warmup, total_steps=total)
    pc = AdamWConfig(warmup_steps=warmup, total_steps=total)
    steps = sorted({0, 1, 2, warmup, warmup + 1, total // 2, total - 1,
                    total, total + 5, *range(0, min(total, 40))})
    f = jax.jit(lambda s: jopt.lr_schedule(jc, s))
    for s in steps:
        want = np.asarray(f(jnp.int32(s)))
        got = optimizer.lr_schedule(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy() == want, (s, got, want)


def _tree_like(tree, rng, scale):
    return jax.tree.map(
        lambda x: (rng.standard_normal(np.shape(x)) * scale).astype(np.float32),
        tree)


def _named_from_tree(tree, cfg):
    """A reference-layout tree -> the port's name -> tensor mapping."""
    return {k: p.detach().clone() for k, p in
            from_reference(tree, cfg, "cpu").named_parameters()}


def test_global_norm_matches_the_reference():
    jcfg = jget_config("codeqwen1.5-7b", reduced=True)
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(2), jcfg))
    grads = _tree_like(tree, np.random.default_rng(2), 0.03)
    want = float(jax.jit(jopt.global_norm)(grads))
    got = float(optimizer.global_norm(_named_from_tree(grads, cfg)))
    assert abs(got - want) <= GNORM_RTOL * want


def _two_updates(arch, grad_scale, seed=3):
    """The reference's jitted ``adamw_update`` and the port's over two
    steps from the same tree and gradients: (reference tree after each
    step, port result as reference trees, reference metrics, port
    metrics)."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    gtrees = [_tree_like(tree, rng, grad_scale) for _ in range(2)]
    jc = JAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jc, p, g, s))
    jp, js, jm = tree, jopt.init_opt_state(tree), []
    m = from_reference(tree, cfg, "cpu")
    named = dict(m.named_parameters())
    ps, tm = optimizer.init_opt_state(named), []
    out = []
    for g in gtrees:
        jp, js, met = upd(jp, g, js)
        jm.append({k: float(v) for k, v in met.items()})
        _, ps, met = optimizer.adamw_update(
            AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4), named,
            _named_from_tree(g, cfg), ps, reference_ndims(m, cfg))
        tm.append({k: float(v) for k, v in met.items()})
        # copies: to_reference's arrays share the parameters' memory, which
        # the next (in-place) update overwrites
        out.append((jax.device_get((jp, js.mu, js.nu)), jax.tree.map(
            np.copy, (to_reference(m, cfg), tree_to_reference(m, ps.mu, cfg),
                      tree_to_reference(m, ps.nu, cfg)))))
    assert int(ps.step) == 2 and ps.step.dtype == torch.int32
    return out, jm, tm


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_bit_exact_below_the_clip(arch):
    out, jm, tm = _two_updates(arch, grad_scale=1e-3)
    assert all(m["grad_norm"] < 1.0 for m in jm)
    for (want, got) in out:
        for wt, gt in zip(want, got):
            for (path, a), b in zip(_leaves(wt), jax.tree_util.tree_leaves(gt)):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (
                    jax.tree_util.keystr(path))
    assert [m["lr"] for m in jm] == [m["lr"] for m in tm]


def test_adamw_within_ulps_when_clipped():
    out, jm, tm = _two_updates("codeqwen1.5-7b", grad_scale=0.1)
    assert all(m["grad_norm"] > 1.0 for m in jm)
    for a, b in zip(jm, tm):
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GNORM_RTOL * a["grad_norm"]
    for (want, got) in out:
        for wt, gt in zip(want, got):
            for (path, a), b in zip(_leaves(wt), jax.tree_util.tree_leaves(gt)):
                assert _ulps(a, b) <= CLIP_ULPS, jax.tree_util.keystr(path)


def test_decay_applies_to_matrices_only():
    """Decay by rank: each tensor's own by default, else the given rank —
    the reference's leaf rank, where a layer's vectors are stacked into
    matrices (C19) and the final norm stays a vector."""
    named = {"w": torch.ones(4, 3), "b": torch.ones(3), "e": torch.ones(2, 2, 2)}
    zeros = {k: torch.zeros_like(v) for k, v in named.items()}
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    optimizer.adamw_update(cfg, named, zeros, optimizer.init_opt_state(named))
    assert torch.equal(named["b"], torch.ones(3))
    assert (named["w"] < 1).all() and (named["e"] < 1).all()
    optimizer.adamw_update(cfg, named, zeros, optimizer.init_opt_state(named),
                           {"w": 1, "b": 2, "e": 3})
    assert (named["b"] < 1).all()
    cfg = get_config("starcoder2-3b", reduced=True)
    from repro_torch.models import init_params
    nd = reference_ndims(init_params(cfg, device="cpu"), cfg)
    assert nd["final_norm.scale"] == 1 and nd["embed"] == 2
    assert nd["layers.0.norm1.scale"] == 2 and nd["layers.1.attn.bq"] == 2
    assert nd["layers.0.attn.wq.weight"] == 3


def test_shared_block_updated_once():
    """zamba2-reduced at two periods: the shared block at two positions."""
    arch = "zamba2-2.7b"
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), n_layers=12)
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=12)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(4), jcfg))
    g = _tree_like(tree, np.random.default_rng(4), 1e-4)
    jc = JAdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    # the state is an argument, as in the reference's trainer (made inside
    # the jit, its step would fold into constants and change the rounding)
    want, _, _ = jax.jit(lambda p, g, s: jopt.adamw_update(jc, p, g, s))(
        tree, g, jopt.init_opt_state(tree))
    m = from_reference(tree, cfg, "cpu")
    shared = [i for i, k in enumerate(cfg.block_kinds) if k == "shared_attn"]
    assert len(shared) > 1 and all(m.layers[i] is m.layers[shared[0]]
                                   for i in shared)
    named = dict(m.named_parameters())
    assert not any(k.startswith(f"layers.{i}.") for i in shared[1:]
                   for k in named)
    optimizer.adamw_update(AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4),
                           named, _named_from_tree(g, cfg),
                           optimizer.init_opt_state(named),
                           reference_ndims(m, cfg))
    got = to_reference(m, cfg)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.device_get(want))
    for (path, a), b in zip(_leaves(jax.device_get(want)),
                            jax.tree_util.tree_leaves(got)):
        assert np.array_equal(np.asarray(a), b), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compression_bit_exact():
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((300, 70)).astype(np.float32),
         "b": (rng.standard_normal(50) * 1e-3).astype(np.float32),
         "z": np.zeros((4, 4), np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
         for k, v in g.items()}
    jpay, jerr = jax.jit(jcomp.compress_grads)(g, e)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    pay, err = comp.compress_grads(tg, {k: torch.from_numpy(v)
                                        for k, v in e.items()})
    dec = comp.decompress_grads(pay)
    jdec = jax.jit(jcomp.decompress_grads)(jpay)
    for k in g:
        assert pay["q"][k].dtype == torch.int8
        assert np.array_equal(np.asarray(jpay["q"][k]), pay["q"][k].numpy())
        assert np.asarray(jpay["scale"][k]) == pay["scale"][k].numpy()
        assert np.array_equal(np.asarray(jerr[k]), err[k].numpy())
        assert np.array_equal(np.asarray(jdec[k]), dec[k].numpy())
    assert all(torch.equal(v, torch.zeros_like(v))
               for v in comp.init_error_state(tg).values())


def test_error_feedback_telescopes():
    """sum of what crossed the wire + the final residual == sum of the
    true gradients (f64 bookkeeping; each step's residual is exact up to
    the f32 rounding of c - q*s)."""
    rng = np.random.default_rng(6)
    err = comp.init_error_state({"w": torch.zeros(64, 64)})
    sent = torch.zeros(64, 64, dtype=torch.float64)
    true = torch.zeros(64, 64, dtype=torch.float64)
    for i in range(20):
        g = {"w": torch.from_numpy(rng.standard_normal((64, 64))
                                   .astype(np.float32)) * (1 + 0.01 * i)}
        pay, err = comp.compress_grads(g, err)
        sent += comp.decompress_grads(pay)["w"].double()
        true += g["w"].double()
    assert torch.allclose(sent + err["w"].double(), true, atol=1e-4)
    assert (err["w"].abs() > 0).any()


# ---------------------------------------------------------------------------
# moe_aux_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-moe-a2.7b"])
def test_moe_aux_loss_matches_the_reference(arch):
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(7), jcfg))
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = next(i for i, k in enumerate(cfg.block_pattern) if "moe" in k)
    jlayer = jax.tree.map(lambda a: a[0], tree["periods"][pos]["moe"])
    want = float(jax.jit(lambda p, x: jmoe.moe_aux_loss(p, x, jcfg))(
        jlayer, x))
    m = from_reference(tree, cfg, "cpu")
    got = float(tmoe.moe_aux_loss(m.layers[pos].moe, torch.from_numpy(x), cfg))
    assert abs(got - want) <= AUX_RTOL * abs(want)
    # ties go to the lower expert: equal router columns
    m.layers[pos].moe.router.weight.data.zero_()
    jz = jax.tree.map(np.zeros_like, jlayer["router"])
    want = float(jmoe.moe_aux_loss(dict(jlayer, router=jz), x, jcfg))
    got = float(tmoe.moe_aux_loss(m.layers[pos].moe, torch.from_numpy(x), cfg))
    assert abs(got - want) <= AUX_RTOL * abs(want)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _train_cfg(**kw):
    return TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=20),
                       log_every=1000, checkpoint_every=10_000, **kw)


def test_trainer_trajectory_matches_the_reference():
    arch = "codeqwen1.5-7b"
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = jax.device_get(jinit_params(jax.random.PRNGKey(8), jcfg))
    dk = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=8)
    jtc = JTrainConfig(optimizer=JAdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=20),
                       log_every=1000, checkpoint_every=10_000)
    jtr = JTrainer(jcfg, jtc, jax.tree.map(jnp.asarray, tree))
    jdata = JTokenPipeline(JDataConfig(**dk))
    want = [h["loss"] for h in jtr.run(jdata, 5, log_fn=lambda s: None)]
    jdata.close()
    tr = Trainer(cfg, _train_cfg(), from_reference(tree, cfg, "cpu"),
                 device="cpu")
    data = TokenPipeline(DataConfig(**dk))
    got = [h["loss"] for h in tr.run(data, 5, log_fn=lambda s: None)]
    data.close()
    assert np.allclose(got, want, rtol=0, atol=TRAJ_ATOL), (got, want)
    assert tr.step == 5 and int(tr.opt_state.step) == 5


def _small(seed=0):
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    from repro_torch.models import init_params
    return cfg, init_params(cfg, seed=seed, device="cpu")


def test_grad_accumulation_equivalence():
    """accum_steps=2 over 2B == accum_steps=1 over the same 2B batch, to
    the reference test's bounds."""
    cfg, params = _small()
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32))}
    out = []
    for accum in (1, 2):
        m = from_reference(to_reference(params, cfg), cfg, "cpu")
        tr = Trainer(cfg, _train_cfg(accum_steps=accum), m, device="cpu")
        out.append((tr.run(iter([batch]), 1, log_fn=lambda s: None)[0], m))
    (h1, m1), (h2, m2) = out
    assert abs(h1["loss"] - h2["loss"]) < 2e-2
    d = max(float((a - b).detach().abs().max()) for a, b in
            zip(m1.parameters(), m2.parameters()))
    assert d < 5e-2


def test_grad_compression_runs():
    cfg, params = _small(1)
    tr = Trainer(cfg, _train_cfg(grad_compression=True), params, device="cpu")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))
    hist = tr.run(data, 3, log_fn=lambda s: None)
    data.close()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert any((e.abs() > 0).any() for e in tr.err_state.values())


def test_watchdog_flags_as_the_reference():
    times = [0.1] * 10 + [1.0, 0.1, 0.35, 0.31, 2.0] + [0.1] * 30 + [0.5]
    a, b = Watchdog(factor=3.0), JWatchdog(factor=3.0)
    assert [a.observe(t) for t in times] == [b.observe(t) for t in times]
    assert a.flagged == b.flagged >= 2


def test_loss_decreases():
    cfg, params = _small()
    tr = Trainer(cfg, _train_cfg(), params, device="cpu")
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8))
    hist = tr.run(data, 25, log_fn=lambda s: None)
    data.close()
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("precision", ["w8a8", "w4a8"])
def test_integer_precision_training_raises(precision):
    cfg = get_config("codeqwen1.5-7b", precision=precision, reduced=True)
    from repro_torch.models import init_params
    with pytest.raises(NotImplementedError, match="rounding"):
        Trainer(cfg, _train_cfg(), init_params(cfg, device="cpu"),
                device="cpu")
