"""Serving tensor parallelism of the port (``dist/tp.py``, ``dist/sharding.py``,
``launch/mesh.py``, ``ServingEngine(tp > 1)``) on the CPU, against the
reference's rules and its tp = 1 engine.

* ``validate_tp_serving`` rejects the same (config, tp) pairs as the
  reference's, with the same messages;
* the shard of every parameter leaf (reduced codeqwen1.5-7b with the
  reference smoke's 8/8 heads and reduced starcoder2-3b, at bf16, W8A8 and
  W4A8, converted from the reference) is the reference's
  ``serve_param_specs`` slice of the reference tree, and every state leaf
  shards as ``serve_state_specs`` says (dense and paged, int8 and bf16);
  a column split of a packed int4 weight never cuts a byte;
* ``tp_boundary_cost`` and ``tp_serving_overlap`` equal the reference's over
  a grid (the reference on its cost-model table: ``REPRO_AUTOTUNE_CACHE``
  points at a missing file);
* the helpers are the identity outside a context and at size 1, and the
  context comes back after an error; ``make_tp_mesh`` refuses tp < 1 and
  NCCL without enough cards;
* ``init_params(shard=(r, tp))`` (a block at a time) equals
  ``shard_params`` of the whole model, and an engine's rank states have the
  shapes of ``shard_states``;
* one spawn each of 2 and 4 gloo CPU ranks (``tests/_tp_ranks.py``) runs the
  reference smoke's four settings (``scripts/tp_equiv_smoke.py``: greedy
  dense, greedy paged ``spec_k`` 4 under pressure, sampled paged, greedy
  paged) at barrier and overlap at bf16, W8A8 and W4A8 (the integer ones on
  the int8 KV cache): tokens equal on every rank, equal to the port's tp 1
  and to ``repro.serve.ServingEngine``'s tp 1; the pressure drain preempts,
  resumes, swaps and accepts drafts; a packed step's logits ``torch.equal``
  to tp 1's; the step runs only all-gathers and all-to-alls, as many as the
  boundary needs (an all-reduce or reduce-scatter raises in the ranks);
  ``run_stream`` on each rank's wall clock gives the offline tokens;
* the launcher serves ``--tp 2`` over gloo on the CPU.
"""
import dataclasses
import functools
import itertools
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.core import costmodel as jcostmodel
from repro.dist.sharding import serve_param_specs, serve_state_specs
from repro.dist.tp import validate_tp_serving as jvalidate
from repro.kernels import autotune as jautotune
from repro.models import init_params as jinit_params
from repro.models import init_states as jinit_states
from repro.quant import ptq_quantize_params as jptq
from repro.quant.ptq import DEFAULT_W4_POLICY as J_W4_POLICY
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

import _tp_ranks
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import from_reference, to_reference
from repro_torch.core import costmodel
from repro_torch.dist import (TPConfigError, TPServing, shard_params,
                              shard_states, tp_out_projection, tp_row_shard,
                              tp_row_unshard, tp_serving, tp_serving_ctx,
                              validate_tp_serving)
from repro_torch.dist.tp import agree
from repro_torch.kernels import autotune
from repro_torch.kernels.int8_gemm import unpack_int4_ref
from repro_torch.launch.mesh import MeshDeviceError, make_tp_mesh, run_ranks
from repro_torch.models import init_params, init_states
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve import engine as engine_mod

PRECISIONS = ("bf16", "w8a8", "w4a8")


def smoke_cfg(get, precision):
    """The reference smoke's config: codeqwen1.5-7b reduced, 8/8 heads."""
    return dataclasses.replace(get("codeqwen1.5-7b", precision=precision,
                                   reduced=True), n_heads=8, n_kv_heads=8)


@functools.lru_cache(maxsize=None)
def ref_tree(jcfg, precision):
    """The reference's seed-0 tree, PTQ'd for ``precision``, as numpy (the
    shard tests and the spawned ranks share it)."""
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    if precision == "w8a8":
        jp = jptq(jp)
    elif precision == "w4a8":
        jp = jptq(jp, policy=J_W4_POLICY)
    return jax.device_get(jp)


# ---------------------------------------------------------------------------
# the rules against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_validate_rejects_what_the_reference_rejects(arch):
    """Every arch, full and reduced, at tp 1..8 (and a kv_source)."""
    for reduced, tp, kv in itertools.product((False, True), range(1, 9),
                                             (None, "x")):
        want = got = None
        try:
            jvalidate(jget_config(arch, reduced=reduced), tp, kv_source=kv)
        except Exception as e:       # the reference's TPConfigError
            want = str(e)
        try:
            validate_tp_serving(get_config(arch, reduced=reduced), tp,
                                kv_source=kv)
        except TPConfigError as e:
            got = str(e)
        assert got == want, (arch, reduced, tp, kv)


def _spec_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "tp"), None)


SHARD_CASES = [("codeqwen", p, tp) for p in PRECISIONS for tp in (2, 4)] + [
    ("starcoder", p, 2) for p in PRECISIONS]


@pytest.mark.parametrize("arch,precision,tp", SHARD_CASES)
def test_param_shards_are_the_reference_specs_slices(arch, precision, tp):
    """Rank r's shard, back in the reference's layout, is leaf for leaf the
    reference tree sliced as ``serve_param_specs`` says."""
    if arch == "codeqwen":
        jcfg, cfg = smoke_cfg(jget_config, precision), smoke_cfg(
            get_config, precision)
    else:
        jcfg = jget_config("starcoder2-3b", precision=precision, reduced=True)
        cfg = get_config("starcoder2-3b", precision=precision, reduced=True)
    tree = ref_tree(jcfg, precision)
    specs = serve_param_specs(tree, tp)
    lm = from_reference(tree, cfg, device="cpu")
    want_leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(spec_leaves) == len(want_leaves)
    n_sharded = 0
    for rank in range(tp):
        got = jax.tree_util.tree_leaves_with_path(
            to_reference(shard_params(lm, rank, tp), cfg))
        assert [p for p, _ in got] == [p for p, _ in want_leaves]
        for (path, g), (_, w), spec in zip(got, want_leaves, spec_leaves):
            dim = _spec_dim(spec)
            if dim is not None:
                n = w.shape[dim] // tp
                w = np.take(w, np.arange(rank * n, (rank + 1) * n), axis=dim)
                n_sharded += rank == 0
            assert g.shape == w.shape and np.array_equal(g, w), path
    # q, k and v, the MLP's up (and gate) and the qkv biases where the arch
    # has them, each a stacked leaf per payload, are split; nothing else is
    per_proj = {"bf16": 1, "w8a8": 2, "w4a8": 3}[precision]
    n_proj = 3 + (2 if cfg.activation == "silu" else 1)
    assert n_sharded == n_proj * per_proj + 3 * cfg.qkv_bias


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_state_shards_follow_serve_state_specs(paged, int8):
    """Each KV payload splits its Hkv axis, positions and page tables stay
    whole: the dims of ``serve_state_specs``; the engine's rank states
    have the shard's shapes."""
    tp = 4
    jcfg, cfg = smoke_cfg(jget_config, "bf16"), smoke_cfg(get_config, "bf16")
    kw = dict(paged_pages=10, page_size=8) if paged else {}
    jst = jinit_states(jcfg, 2, 64, int8_kv=int8, **kw)
    jdims = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            serve_state_specs(jst, tp),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        name = str(getattr(path[-1], "key", path[-1]))
        d = _spec_dim(spec)
        jdims[name] = None if d is None else d - len(spec)
    st = init_states(cfg, 2, 64, int8_kv=int8, device="cpu", **kw)
    lm = init_params(cfg, device="cpu")
    for rank in range(tp):
        # the engine allocates its rank's states at the shard's shapes
        eng = ServingEngine(shard_params(lm, rank, tp), cfg, ServeConfig(
            batch_lanes=2, max_seq=64, int8_kv=int8, paged=paged,
            page_size=8, pool_pages=10, tp=tp), device="cpu",
            mesh=Mesh(size=tp, rank=rank))
        for mine, part in zip(eng.states, shard_states(st, rank, tp)):
            assert {k: (v.shape, v.dtype) for k, v in mine["kv"].items()} \
                == {k: (v.shape, v.dtype) for k, v in part["kv"].items()}
        for full, part in zip(st, shard_states(st, rank, tp)):
            for name, t in full["kv"].items():
                d = jdims[name]
                if d is None:
                    assert part["kv"][name] is t, name
                    continue
                n = t.shape[d] // tp
                assert torch.equal(part["kv"][name],
                                   t.narrow(d, rank * n, n)), name
    assert {n for n, d in jdims.items() if d is not None} == (
        {"pk", "pv"} | ({"pks", "pvs"} if int8 else set()) if paged else
        {"k", "v"} | ({"k_s", "v_s"} if int8 else set()))


def test_int4_column_split_never_cuts_a_packed_byte():
    """``w4`` [K/2, N] packs two contraction rows a byte: its columns split
    into whole columns of both rows."""
    cfg = smoke_cfg(get_config, "w4a8")
    lm = init_params(cfg, device="cpu", precision="w4a8")
    w4 = lm.layers[0].mlp.w_in.w4
    k = 2 * w4.shape[0]
    full = unpack_int4_ref(w4, k)
    n = w4.shape[1] // 4
    for r in range(4):
        cols = slice(r * n, (r + 1) * n)
        assert torch.equal(unpack_int4_ref(w4[:, cols].contiguous(), k),
                           full[:, cols])
        assert torch.equal(shard_params(lm, r, 4).layers[0].mlp.w_in.w4,
                           w4[:, cols])


@pytest.fixture
def table_only():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", "/nonexistent/repro-autotune.json")
    jautotune.reset_measured_cache()
    jautotune.tp_serving_overlap.cache_clear()
    yield
    mp.undo()
    jautotune.reset_measured_cache()
    jautotune.tp_serving_overlap.cache_clear()


def test_boundary_rule_equals_the_reference(table_only):
    archs = [get_config(a) for a in ARCH_IDS]
    seen = set()
    for rows, tp, overlap, c in itertools.product(
            (1, 8, 16, 64, 256, 2048, 8192), (1, 2, 3, 4, 8), (False, True),
            archs):
        hd = c.n_heads * c.head_dim
        assert costmodel.tp_boundary_cost(rows, c.d_ff, c.d_model, tp,
                                          overlap) == \
            jcostmodel.tp_boundary_cost(rows, c.d_ff, c.d_model, tp, overlap)
        got = autotune.tp_serving_overlap(rows, c.d_model, c.d_ff, hd, tp)
        assert got == jautotune.tp_serving_overlap(
            rows, c.d_model, c.d_ff, hd, tp, backend="jnp")
        seen.add(got)
    assert seen == {"barrier", "overlap"}


def test_helpers_are_the_identity_outside_a_context_and_at_size_one():
    x = torch.randn(2, 3, 8)
    calls = []

    def out(h, res):
        calls.append(h)
        return h * 2 + (0 if res is None else res)

    for ctx in (None, TPServing(size=1, overlap=True),
                TPServing(size=1, overlap=False)):
        with tp_serving(ctx):
            assert tp_row_shard(x) is x
            assert tp_row_unshard(x, 2, 3) is x
            pair = (x, None)
            assert tp_row_unshard(pair, 2, 3) is pair
            assert torch.equal(tp_out_projection(x, x, out), x * 3)
            assert calls[-1] is x
    # barrier at size > 1 leaves the stream whole: no row sharding
    with tp_serving(TPServing(size=2, overlap=False)):
        assert tp_row_shard(x) is x and tp_row_unshard(x, 2, 3) is x
    outer = TPServing(size=2)
    with tp_serving(outer):
        with pytest.raises(RuntimeError):
            with tp_serving(TPServing(size=4, overlap=True)):
                raise RuntimeError("inside")
        assert tp_serving_ctx() is outer
    assert tp_serving_ctx() is None


def test_mesh_refusals(monkeypatch):
    with pytest.raises(MeshDeviceError, match="tp must be >= 1"):
        make_tp_mesh(0, "gloo", rank=0, port=1)
    with pytest.raises(MeshDeviceError, match="needs 2 cards"):
        make_tp_mesh(2, "nccl", rank=0, port=1)
    # gloo's ranks go on the card unless the caller names the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tp_mesh(2, "gloo", rank=0, port=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(MeshDeviceError, match="needs 4 cards, but 3"):
        make_tp_mesh(4, "nccl", rank=0, port=1)
    with pytest.raises(ValueError, match="gloo' or 'nccl"):
        make_tp_mesh(2, "mpi", rank=0, port=1)


@dataclasses.dataclass
class Mesh:
    """A rank's view of a TP group, without the group: an engine is built
    (no collective runs before its first step)."""
    size: int = 2
    rank: int = 1
    group: object = None


def test_engine_refuses_tp_without_a_group_or_with_another_shard():
    cfg = smoke_cfg(get_config, "bf16")
    lm = init_params(cfg, device="cpu")
    sc = _tp_ranks.scfg("bf16", {}, tp=2)
    with pytest.raises(TPConfigError, match="TP group of 2 ranks"):
        ServingEngine(lm, cfg, sc, device="cpu")
    with pytest.raises(TPConfigError, match="shard \\(0, 1\\)"):
        ServingEngine(lm, cfg, sc, device="cpu", mesh=Mesh())
    with pytest.raises(TPConfigError, match="block kinds"):
        mcfg = get_config("mixtral-8x7b", reduced=True)
        ServingEngine(init_params(mcfg, device="cpu"), mcfg, sc,
                      device="cpu", mesh=Mesh())


class _Stop(Exception):
    pass


def test_agree_moves_its_integer_on_the_ranks_device(monkeypatch):
    """``run_stream``'s arrivals are agreed on through an all-gather that
    NCCL would refuse for a host tensor: ``agree`` builds its integer on
    the device it is given, and the engine gives its own."""
    seen = []

    def all_gather(outs, x, group=None):
        seen.append(x.device)
        raise _Stop

    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "all_gather", all_gather)
    with pytest.raises(_Stop):
        agree(3, TPServing(size=2), torch.device("meta"))
    assert seen == [torch.device("meta")]
    assert agree(3, None, torch.device("meta")) == 3

    def record(n, ctx, device):
        seen.append((ctx.size, device))
        raise _Stop

    cfg = smoke_cfg(get_config, "bf16")
    lm = shard_params(init_params(cfg, device="cpu"), 1, 2)
    eng = ServingEngine(lm, cfg, _tp_ranks.scfg("bf16", {}, tp=2),
                        device="cpu", mesh=Mesh())
    monkeypatch.setattr(engine_mod, "agree", record)
    with pytest.raises(_Stop):
        eng.run_stream([(0.0, dict(prompt=[3, 4, 5], max_new=2))])
    assert seen[-1] == (2, torch.device("cpu"))


@pytest.mark.parametrize("precision", ["bf16", "w4a8"])
def test_shard_built_a_block_at_a_time_equals_the_sliced_model(precision):
    cfg = smoke_cfg(get_config, precision)
    whole = init_params(cfg, seed=5, device="cpu", precision=precision)
    for rank in range(2):
        own = init_params(cfg, seed=5, device="cpu", precision=precision,
                          shard=(rank, 2))
        cut = shard_params(whole, rank, 2)
        assert own.tp_shard == cut.tp_shard == (rank, 2)
        a = dict(itertools.chain(own.named_parameters(), own.named_buffers()))
        b = dict(itertools.chain(cut.named_parameters(), cut.named_buffers()))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # shard_params leaves the whole model as it was
    again = init_params(cfg, seed=5, device="cpu", precision=precision)
    for (k, v), (_, w) in zip(whole.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(v, w), k


# ---------------------------------------------------------------------------
# tp 2 and tp 4 ranks against tp 1 and the reference engine
# ---------------------------------------------------------------------------

# the reference engine's tp 1 drains: greedy tokens do not depend on the
# schedule, lanes, paging or speculation (the reference's contract), so its
# greedy dense drain stands for the three greedy settings
REF_DRAINS = {"greedy": ("greedy/dense/k0", dict()),
              "sampled": ("sampled/paged/k0",
                          dict(paged=True, page_size=8, temperature=0.8))}
TPS = (2, 4)


@pytest.fixture(scope="module")
def smoke():
    """Per precision: the config, the reference tree, the port's tp 1
    results and the reference engine's tp 1 tokens; per tp, every rank's
    results.  The ranks run in a thread of their own (two groups, one after
    the other) while this process drains tp 1."""
    cfgs = {p: smoke_cfg(get_config, p) for p in PRECISIONS}
    jcfgs = {p: smoke_cfg(jget_config, p) for p in PRECISIONS}
    trees = {p: ref_tree(jcfgs[p], p) for p in PRECISIONS}
    ranks, failed = {}, []

    def spawn():
        try:
            for tp in TPS:
                ranks[tp] = run_ranks(_tp_ranks.rank_drains, tp, tp, cfgs,
                                      trees)
        except BaseException as e:   # re-raised below, in the test
            failed.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    out = {}
    for precision in PRECISIONS:
        cfg, tree = cfgs[precision], trees[precision]
        lm = from_reference(tree, cfg, device="cpu")
        port = {label: _tp_ranks.drain(ServingEngine(
            lm, cfg, _tp_ranks.scfg(precision, over), device="cpu"))
            for label, over, _ in _tp_ranks.SETTINGS}
        port["logits"] = _tp_ranks.step_logits(ServingEngine(
            lm, cfg, _tp_ranks.scfg(precision, {}), device="cpu"))
        ref = {}
        for kind, (_, over) in REF_DRAINS.items():
            jeng = JServingEngine(tree, jcfgs[precision], JServeConfig(
                **{**_tp_ranks.BASE, **over},
                int8_kv=precision != "bf16"))
            jeng._clock = itertools.count().__next__
            for i, p in enumerate(_tp_ranks.PROMPTS):
                jeng.submit(list(p), max_new=_tp_ranks.MAX_NEW, request_id=i)
            ref[kind] = {d["id"]: d["tokens"]
                         for d in jeng.run_until_drained()}
        out[precision] = dict(cfg=cfg, port=port, ref=ref)
    thread.join(timeout=900)
    assert not thread.is_alive(), "the TP ranks did not finish"
    if failed:
        raise failed[0]
    return out, ranks


@pytest.mark.parametrize("tp", TPS)
def test_tokens_equal_tp1_and_the_reference(smoke, tp):
    out, ranks = smoke
    for precision in PRECISIONS:
        want = out[precision]
        for label, _, require in _tp_ranks.SETTINGS:
            toks1, stats1 = want["port"][label]
            ref = want["ref"]["sampled" if label.startswith("sampled")
                              else "greedy"]
            assert toks1 == ref, (precision, label)
            for s in require:
                assert stats1[s] > 0, (precision, label, s)
            for overlap in ("barrier", "overlap"):
                for rank in range(tp):
                    toks, stats = ranks[tp][rank][precision, overlap][label]
                    assert toks == toks1, (tp, precision, overlap, label,
                                           rank)
                    assert stats == stats1, (tp, precision, overlap, label)
    # run_stream on every rank (the last precision's shard, overlap): the
    # offline greedy drain's tokens
    last = PRECISIONS[-1]
    for rank in range(tp):
        assert ranks[tp][rank]["stream", last] == \
            out[last]["port"]["greedy/dense/k0"][0]


@pytest.mark.parametrize("tp", TPS)
def test_step_logits_and_collectives(smoke, tp):
    out, ranks = smoke
    for precision in PRECISIONS:
        want = torch.from_numpy(out[precision]["port"]["logits"])
        layers = out[precision]["cfg"].n_layers
        for overlap in ("barrier", "overlap"):
            for rank in range(tp):
                got = ranks[tp][rank][precision, overlap]
                assert got["resolved"] == overlap
                assert torch.equal(torch.from_numpy(got["logits"]), want), (
                    tp, precision, overlap, rank)
                # barrier: a gather in front of wo and of w_out a layer;
                # overlap: an all-to-all there, a row gather in front of
                # QKV, MLP-in and the head
                assert got["collectives"] == (
                    {"all_gather": 2 * layers} if overlap == "barrier" else
                    {"all_to_all": 2 * layers,
                     "all_gather": 2 * layers + 1})


def test_launcher_serves_tp2_over_gloo(capfd):
    from repro_torch.launch.serve import main
    argv = ["--arch", "codeqwen1.5-7b", "--reduced", "--w4a8", "--int8-kv",
            "--device", "cpu", "--requests", "3", "--max-new", "4"]
    main(argv)
    one = capfd.readouterr().out
    main(argv + ["--tp", "2", "--tp-backend", "gloo"])
    two = capfd.readouterr().out
    assert "tensor parallel: tp=2 over ['cpu', 'cpu'] (gloo, boundary=" in two
    assert two.count("served 3 requests, 12 tokens") == 1
    # the same schedule: the stats line but for its latencies
    strip = [ln.split(" ttft_p50")[0] for ln in (one, two)
             for ln in ln.splitlines() if ln.startswith("mode=")]
    assert strip[0] == strip[1]
    with pytest.raises(TPConfigError, match="block kinds"):
        main(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
              "--tp", "2"])
