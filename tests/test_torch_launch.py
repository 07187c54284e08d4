"""The port's launch planning against the reference: ``launch/specs.py``'s
``make_cell_plan``, ``input_specs`` and ``state_specs`` on every arch and
cell (one stand-in mesh shape handed to both packages), ``roofline``'s
``active_params`` and ``model_flops`` with ``==``, ``launch/mesh.py``'s
``MeshDeviceError`` where the cards fall short, the dry-run plan's per-rank
parameter bytes against bytes computed from the reference's
``param_specs``, a fits verdict for every cell, and the serving-TP cell's
collectives over gloo."""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, cells
from repro.configs import get_config as jget_config
from repro.dist import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.launch import dryrun, mesh, roofline, specs

MESHES = {"16x16": mesh.make_production_mesh(n_devices=512),
          "2x16x16": mesh.make_production_mesh(multi_pod=True,
                                               n_devices=512)}
CELLS = [(a, s) for a in ARCH_IDS for s in cells(a)]


@pytest.fixture(autouse=True)
def _restore_envs():
    yield
    jsh.set_axis_env(jsh.AxisEnv())
    sharding.set_axis_env(sharding.AxisEnv())


def _plan_fields(plan) -> tuple:
    env = plan.env
    return ((env.dp, env.fsdp, env.tp, env.ep, env.sp, env.active,
             env.sizes), plan.kv_heads_on_model, plan.ep_mode,
            plan.batch_axes, plan.seq_axes_kv)


def _ref_flat(tree, leaf=lambda x: x) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf(x) for path, x in leaves}


def _flat(tree, leaf=lambda x: x) -> dict:
    out = {}
    sharding.map_with_path(tree, lambda path, x: out.__setitem__(path,
                                                                 leaf(x)))
    return out


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("variant", ["baseline", "no_tp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cell_plans_equal_the_references(mesh_name, variant):
    """Every arch x cell, fsdp on and off: the plan's env, KV and expert
    placement, batch and KV-sequence axes."""
    m = MESHES[mesh_name]
    for arch, shape in CELLS:
        s = SHAPES[shape]
        for fsdp in (True, False):
            want = jspecs.make_cell_plan(jget_config(arch), m, s["kind"],
                                         s["global_batch"], fsdp, variant)
            got = specs.make_cell_plan(get_config(arch), m, s["kind"],
                                       s["global_batch"], fsdp, variant)
            assert _plan_fields(got) == _plan_fields(want), (arch, shape)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_state_specs_equal_the_references(arch, shape, int8_kv):
    """The cell's inputs (shape, dtype; the states in the reference's
    stacked layout) and each state leaf's spec under the cell's plan on
    the 2 x 16 x 16 mesh."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    s = SHAPES[shape]
    want = jspecs.input_specs(jcfg, s["kind"], s["seq_len"],
                              s["global_batch"], int8_kv)
    got = specs.input_specs(cfg, s["kind"], s["seq_len"], s["global_batch"],
                            int8_kv)
    assert sorted(got) == sorted(want)
    for name, x in got.items():
        if name != "states":
            assert (tuple(x.shape), _dtype(x.dtype)) == (
                want[name].shape, str(want[name].dtype))
            assert x.device.type == "meta"
            continue
        stacked = specs.stacked_states(x, cfg)
        assert _flat(stacked, lambda v: (v.shape, _dtype(v.dtype))) == \
            _ref_flat(want[name], lambda v: (v.shape, str(v.dtype)))
        m = MESHES["2x16x16"]
        jplan = jspecs.make_cell_plan(jcfg, m, s["kind"], s["global_batch"])
        plan = specs.make_cell_plan(cfg, m, s["kind"], s["global_batch"])
        assert _flat(specs.state_specs(x, plan, cfg)) == _ref_flat(
            jspecs.state_specs(want[name], jplan), tuple)


@pytest.mark.parametrize("arch", ARCH_IDS + ["qwen2-moe-a2.7b-reduced"])
def test_active_params_and_model_flops(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert roofline.active_params(cfg) == jroof.active_params(jcfg)
    for shape in SHAPES.values():
        assert roofline.model_flops(cfg, shape) == jroof.model_flops(jcfg,
                                                                     shape)


def test_meshes_raise_where_the_cards_fall_short(monkeypatch):
    """One card (or none) falls short of every production mesh; an elastic
    mesh off the model axis's multiple raises before counting cards, and
    256 cards hold a 16 x 16 one."""
    for cards in (0, 1):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        for make in (mesh.make_production_mesh,
                     lambda: mesh.make_production_mesh(multi_pod=True),
                     lambda: mesh.make_elastic_mesh(256)):
            with pytest.raises(mesh.MeshDeviceError, match="cards"):
                make()
    with pytest.raises(mesh.MeshDeviceError, match="multiple"):
        mesh.make_elastic_mesh(100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 256)
    el = mesh.make_elastic_mesh(256)
    assert el.shape == {"data": 16, "model": 16} and el.size == 256
    assert mesh.mesh_axis_size(el, "pod") == 1
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}


@functools.lru_cache(maxsize=None)
def _ref_tree(arch: str):
    return jspecs.abstract_params(jget_config(arch))


def _ref_param_bytes(jcfg, kind: str, sizes: dict) -> int:
    """A rank's parameter bytes from the reference's ``param_specs`` of
    ``jax.eval_shape``'s tree (serving: f32 matrices cast to bf16, as its
    dry run casts them)."""
    tree = _ref_tree(jcfg.name)
    if kind != "train":
        tree = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape, jnp.bfloat16) if (x.dtype == jnp.float32
                                       and len(x.shape) >= 2) else x, tree)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jsh.param_specs(tree),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dry_run_param_bytes_and_verdict(arch, multi_pod):
    """Every cell's plan records a rank's bytes, parts summing to the
    total, a fits verdict against 80 GB and the model FLOPs a card; its
    parameter bytes equal those computed from the reference's specs."""
    m = MESHES["2x16x16" if multi_pod else "16x16"]
    jcfg = jget_config(arch)
    for shape in cells(arch):
        rec = dryrun.run_cell(arch, shape, multi_pod, save=False)
        kind = SHAPES[shape]["kind"]
        jplan = jspecs.make_cell_plan(jcfg, m, kind,
                                      SHAPES[shape]["global_batch"])
        jsh.set_axis_env(jplan.env)
        nb = rec["bytes_per_device"]
        assert nb["params"] == _ref_param_bytes(jcfg, kind, m.shape)
        assert nb["total"] == sum(v for k, v in nb.items() if k != "total")
        assert rec["fits"] == (nb["total"] <= 80 * 10 ** 9)
        assert (kind == "train") == (nb["optimizer"] > 0)
        assert rec["model_flops_per_device"] == jroof.model_flops(
            jcfg, SHAPES[shape]) / m.size
        assert rec["temporaries"].startswith("not counted")


def test_roofline_reads_the_dry_run_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    dryrun.run_cell("starcoder2-3b", "decode_32k", False)
    dryrun.run_cell("starcoder2-3b", "train_4k", False)
    rows = [roofline.roofline_row(r) for r in roofline.load_cells("16x16")]
    assert sorted(r["shape"] for r in rows) == ["decode_32k", "train_4k"]
    for r in rows:
        assert r["compute_s"] > 0 and r["memory_s"] > 0 and r["fits"]
    decode = next(r for r in rows if r["shape"] == "decode_32k")
    assert decode["dominant"] == "memory"


def test_tp_serve_cell_moves_data_only():
    """The overlap boundary at tp 2 over gloo: all-to-alls and all-gathers,
    every summing collective refused in the ranks, the ranks' tokens
    equal."""
    rec = dryrun.run_tp_serve_cell("overlap", tp=2, device="cpu")
    assert rec["devices"] == ["cpu", "cpu"]
    cc = rec["collective_counts"]
    assert cc["all_to_all"] >= 1 and cc["all_gather"] >= 1
