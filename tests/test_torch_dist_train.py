"""The port's training distribution rules against the reference: the axis
environment and divisibility demotion of ``dist/sharding.py``,
``param_specs`` of every arch's meta tree equal to the reference's
``PartitionSpec``s of ``jax.eval_shape``'s tree leaf by leaf,
``shard_hint`` the identity, and ``dist/pipeline.py``'s ``split_stages``,
``bubble_fraction`` (``==``) and ``pipeline_apply`` over a gloo group of 2
CPU ranks equal to the unpipelined stack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.dist import pipeline as jpipe
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import init_params as jinit_params
from repro.quant import ptq as jptq
from repro.quant import ptq_quantize_params
from repro_torch.configs import get_config
from repro_torch.dist import pipeline, sharding
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"16x16": make_production_mesh(n_devices=512),
          "2x16x16": make_production_mesh(multi_pod=True, n_devices=512)}


@pytest.fixture(autouse=True)
def _restore_envs():
    yield
    jsh.set_axis_env(jsh.AxisEnv())
    sharding.set_axis_env(sharding.AxisEnv())


def _env_fields(env) -> tuple:
    return (env.dp, env.fsdp, env.tp, env.ep, env.sp, env.active, env.sizes)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _flat(tree) -> dict:
    out = {}
    sharding.map_with_path(tree, lambda path, spec: out.__setitem__(path,
                                                                    spec))
    return out


def _bind(arch: str, mesh: str, kind: str, batch: int):
    """Bind both packages' envs to the cell plan (the reference's plan from
    the same stand-in mesh) and return the two configs."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jplan = jspecs.make_cell_plan(jcfg, MESHES[mesh], kind, batch)
    plan = specs.make_cell_plan(cfg, MESHES[mesh], kind, batch)
    assert _env_fields(plan.env) == _env_fields(jplan.env)
    jsh.set_axis_env(jplan.env)
    sharding.set_axis_env(plan.env)
    return jcfg, cfg


@pytest.mark.parametrize("mesh,kind,batch", [("16x16", "train", 256),
                                             ("2x16x16", "prefill", 32)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh, kind, batch):
    """Every leaf's spec, by path, under the cell's bound env: the port's
    meta tree (``convert.reference_shapes``) against ``jax.eval_shape`` of
    the reference's init."""
    jcfg, cfg = _bind(arch, mesh, kind, batch)
    want = _ref_flat(jsh.param_specs(jspecs.abstract_params(jcfg)))
    got = _flat(sharding.param_specs(specs.abstract_params(cfg), cfg))
    assert got == want


@pytest.mark.parametrize("precision", ["w8a8", "w4a8"])
def test_param_specs_of_a_quantized_tree(precision):
    """The PTQ payload leaves (``w_q``/``w4``, ``qmul``, ``scale`` under
    each projection) take the reference's specs too: reduced codeqwen1.5-7b
    quantized by the reference (its PTQ reads values, so it runs on
    arrays; W4A8 by its default W4 policy) against the port's meta tree
    quantized as it is built."""
    jcfg = jget_config("codeqwen1.5-7b", precision=precision, reduced=True)
    cfg = get_config("codeqwen1.5-7b", precision=precision, reduced=True)
    env = dict(fsdp=("data",), tp=("model",), active=True,
               sizes=(("data", 2), ("model", 4)))
    jsh.set_axis_env(jsh.AxisEnv(**env))
    sharding.set_axis_env(sharding.AxisEnv(**env))
    policy = None if precision == "w8a8" else jptq.DEFAULT_W4_POLICY
    jtree = ptq_quantize_params(jinit_params(jax.random.PRNGKey(0), jcfg),
                                policy=policy)
    got = _flat(sharding.param_specs(specs.abstract_params(cfg, precision),
                                     cfg))
    assert got == _ref_flat(jsh.param_specs(jtree))


@pytest.mark.parametrize("logical,dim,axes", [
    ("tp", 4096, ("model",)), ("tp", 100, ("model",)),
    ("fsdp", 4096, ("data", "model")), ("fsdp", 48, ("data", "model")),
    ("dp", 24, ("pod", "data")), ("ep", 8, ("model",)), (None, 64, ())])
def test_resolve_dim_demotes_as_the_reference(logical, dim, axes):
    sizes = (("pod", 2), ("data", 16), ("model", 16))
    kw = {} if logical is None else {logical: axes}
    env, jenv = (sharding.AxisEnv(active=True, sizes=sizes, **kw),
                 jsh.AxisEnv(active=True, sizes=sizes, **kw))
    for used in (set(), {"data"}):
        got = sharding._resolve_dim(env, logical, dim, set(used))
        assert got == jsh._resolve_dim(jenv, logical, dim, set(used))
    assert env.axes_size(axes) == jenv.axes_size(axes)


def test_axis_env_and_shard_hint():
    """``set_axis_env`` binds, ``axis_env`` reads, and ``shard_hint`` is the
    identity — the port binds no training mesh (the reference's trainer
    binds none either, so its hints are no-ops there too)."""
    env = sharding.AxisEnv(tp=("model",), active=True,
                           sizes=(("model", 16),))
    sharding.set_axis_env(env)
    assert sharding.axis_env() is env
    x = torch.arange(32.0).reshape(2, 16)
    assert sharding.shard_hint(x, None, "tp") is x


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
@pytest.mark.parametrize("micro", [1, 4, 8, 32])
def test_bubble_fraction(stages, micro):
    assert (pipeline.bubble_fraction(stages, micro)
            == jpipe.bubble_fraction(stages, micro))


def test_split_stages_equals_the_references():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "b": [rng.standard_normal((8, 5)).astype(np.float32)]}
    want = jpipe.split_stages(jax.tree.map(jnp.asarray, tree), 4)
    got = pipeline.split_stages(
        {"w": torch.from_numpy(tree["w"]),
         "b": [torch.from_numpy(tree["b"][0])]}, 4)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))
    with pytest.raises(ValueError, match="do not split"):
        pipeline.split_stages(torch.zeros(6, 2), 4)


def test_pipeline_apply_over_two_gloo_ranks():
    """GPipe over 2 CPU ranks (gloo): every rank returns the last stage's
    outputs, ``torch.equal`` to the unpipelined stack of the same layers
    (``launch.dryrun.run_pipeline_cell``)."""
    rec = dryrun.run_pipeline_cell(n_stages=2, n_microbatches=4, n_layers=4,
                                   d_model=64, microbatch=3, device="cpu")
    assert rec["ranks_equal_unpipelined"]
    assert rec["devices"] == ["cpu", "cpu"] and rec["backend"] == "gloo"
    assert rec["schedule_steps"] == 5
    assert rec["bubble_fraction"] == jpipe.bubble_fraction(2, 4)


@pytest.mark.parametrize("cell", ["pipeline", "tp_serve"])
def test_the_rank_cells_run_on_the_card_unless_asked(cell, monkeypatch):
    """With no device named, the pipeline and serving-TP cells take the
    card: with none present they raise before spawning a rank, and never
    fall back to the CPU; NCCL takes no CPU device."""
    run = {"pipeline": lambda **kw: dryrun.run_pipeline_cell(2, 2, **kw),
           "tp_serve": lambda **kw: dryrun.run_tp_serve_cell("barrier",
                                                             **kw)}[cell]
    monkeypatch.setattr(dryrun, "run_ranks", lambda *a: pytest.fail(
        "a rank was spawned"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    with pytest.raises(ValueError, match="nccl"):
        run(device="cpu", backend="nccl")
