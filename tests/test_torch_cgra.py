"""The port's NX-CGRA fabric model (``repro_torch.core``) against the
reference's (``repro.core``): the six Table II kernels built, scheduled and
simulated once in each package on the CPU, then held equal — inputs, task
graphs, programs, every ``SimResult`` field and ``metrics_from_sim`` with
``==``, payload outputs bit for bit — beside the area table, Table II's
effective MOPS over ``EDGE_MODELS`` and the reference tests' geometry and
tolerance checks on the port's modules."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import edge_models as ref_edge
from repro.core import (BUILDERS as REF_BUILDERS, Simulator as RefSimulator,
                        StaticScheduler as RefScheduler,
                        metrics_from_sim as ref_metrics)
from repro.core import costmodel as ref_cost
from repro_torch.configs import edge_models
from repro_torch.core import (BUILDERS, Simulator, StaticScheduler,
                              metrics_from_sim, costmodel)
from repro_torch.core import isa
from repro_torch.core.isa import N_MOB, N_PE, core_position, torus_hops
from repro_torch.kernels import ops

NAMES = sorted(REF_BUILDERS)


def _run(builders, scheduler, simulator, metrics, **kw):
    out = {}
    for name in sorted(builders):
        ki = builders[name](**kw)
        env_in = dict(ki.env)
        prog = scheduler().schedule(ki.tasks, name=name,
                                    context_phases=ki.context_phases)
        res = simulator().run(prog, ki.env)
        out[name] = (ki, env_in, prog, res, metrics(name, res, ki.useful_ops))
    return out


@pytest.fixture(scope="module")
def runs():
    ops.reset_launch_counts()
    port = _run(BUILDERS, StaticScheduler, Simulator, metrics_from_sim,
                device="cpu")
    launched = dict(ops.launch_counts())
    ref = _run(REF_BUILDERS, RefScheduler, RefSimulator, ref_metrics)
    return port, ref, launched


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ops(d):
    return {cls.value: n for cls, n in d.items()}


def _op(op):
    return (op.cls.value, op.count, op.hops, op.bank, op.tag)


def _core(c):
    return (c.core_id, c.is_mob,
            [[(_op(s.op), s.fn is not None) for s in seg] for seg in c.segments])


class TestGeometry:
    def test_positions_unique(self):
        seen = {core_position(i, False) for i in range(N_PE)}
        seen |= {core_position(i, True) for i in range(N_MOB)}
        assert len(seen) == N_PE + N_MOB == 24

    def test_torus_symmetric_and_bounded(self):
        a, b = core_position(0, True), core_position(15, False)
        assert torus_hops(a, b) == torus_hops(b, a)
        assert 0 < torus_hops(a, b) <= 2 + 3  # torus diameter of 4x6

    def test_constants_equal_the_references(self):
        from repro.core import isa as ref_isa
        for k in ("FREQ_HZ", "N_PE", "N_MOB", "ISSUE_OVERHEAD", "DIV_LATENCY",
                  "L1_BANKS", "LEAKAGE_W", "IDLE_CORE_W"):
            assert getattr(isa, k) == getattr(ref_isa, k), k
        assert {c.value: v for c, v in isa.ENERGY_PJ.items()} == {
            c.value: v for c, v in ref_isa.ENERGY_PJ.items()}
        assert [c.value for c in isa.OpClass] == [c.value for c in ref_isa.OpClass]
        for n in (1, 7, 24):
            assert isa.context_load_cycles(n) == ref_isa.context_load_cycles(n)
            assert isa.context_load_cycles(n, 96) == \
                ref_isa.context_load_cycles(n, 96)
        for a in range(N_PE):
            for b in range(N_MOB):
                pa, pb = core_position(a, False), core_position(b, True)
                assert pa == ref_isa.core_position(a, False)
                assert pb == ref_isa.core_position(b, True)
                assert torus_hops(pa, pb) == ref_isa.torus_hops(pa, pb)


@pytest.mark.parametrize("name", NAMES)
class TestKernel:
    def test_inputs_equal(self, runs, name):
        port, ref, _ = runs
        p_env, r_env = port[name][1], ref[name][1]
        assert set(p_env) == set(r_env)
        for k in r_env:
            want = np.asarray(r_env[k])
            got = _np(p_env[k])
            assert got.dtype == want.dtype and np.array_equal(got, want), k

    def test_task_graphs_equal(self, runs, name):
        port, ref, _ = runs
        pt, rt = port[name][0].tasks, ref[name][0].tasks
        assert len(pt) == len(rt)
        for a, b in zip(pt, rt):
            assert (a.name, a.kind, a.phase, _ops(a.ops), a.in_bytes,
                    a.out_bytes, a.nbytes, a.addr, a.fn is None) == \
                (b.name, b.kind, b.phase, _ops(b.ops), b.in_bytes,
                 b.out_bytes, b.nbytes, b.addr, b.fn is None)
        pk, rk = port[name][0], ref[name][0]
        assert (pk.name, pk.out_key, pk.out_scale, pk.useful_ops,
                pk.context_phases) == (rk.name, rk.out_key, rk.out_scale,
                                       rk.useful_ops, rk.context_phases)

    def test_programs_equal(self, runs, name):
        port, ref, _ = runs
        pp, rp = port[name][2], ref[name][2]
        assert (pp.n_barriers, pp.context_phases, pp.name) == \
            (rp.n_barriers, rp.context_phases, rp.name)
        assert [_core(c) for c in pp.pes + pp.mobs] == \
            [_core(c) for c in rp.pes + rp.mobs]
        assert [_op(s.op) for s in pp.exec_order] == \
            [_op(s.op) for s in rp.exec_order]
        assert _ops(pp.op_histogram()) == _ops(rp.op_histogram())
        assert pp.programmed_cores() == rp.programmed_cores()

    def test_sim_results_equal(self, runs, name):
        port, ref, _ = runs
        pr, rr = port[name][3], ref[name][3]
        assert pr.cycles == rr.cycles
        assert pr.context_cycles == rr.context_cycles
        assert pr.segment_cycles == rr.segment_cycles
        assert pr.energy_j == rr.energy_j
        assert _ops(pr.op_hist) == _ops(rr.op_hist)
        assert pr.core_busy == rr.core_busy
        assert (pr.time_s, pr.power_w, pr.utilization()) == \
            (rr.time_s, rr.power_w, rr.utilization())

    def test_metrics_equal(self, runs, name):
        port, ref, _ = runs
        assert dataclasses.astuple(port[name][4]) == \
            dataclasses.astuple(ref[name][4])

    def test_payload_outputs_bit_equal(self, runs, name):
        port, ref, _ = runs
        pe, re_ = port[name][3].env, ref[name][3].env
        assert set(pe) == set(re_)
        for k in re_:
            want, got = np.asarray(re_[k]), _np(pe[k])
            assert got.shape == want.shape, k
            assert np.array_equal(got.astype(np.int64) if got.dtype != bool
                                  and got.dtype.kind in "iu" else got,
                                  want.astype(np.int64) if want.dtype != bool
                                  and want.dtype.kind in "iu" else want), k


class TestFunctional:
    """The reference tests' checks (``tests/test_cgra.py``) on the port's
    payloads and torch float references."""

    def test_gemm_bit_exact_requant(self, runs):
        from repro_torch.core import inumerics as inum
        ki, _, _, res, _ = runs[0]["gemm"]
        rq = inum.compute_requant_params(
            0.02 * 0.02 / ki.out_scale, acc_bound=64 * 127 * 127)
        expect = inum.requantize(ki.ref_fn(res.env).to(torch.int32), rq)
        assert torch.equal(res.env["out"], expect)

    def test_sftmx_close_to_float(self, runs):
        ki, _, _, res, _ = runs[0]["sftmx"]
        got = res.env["out"].double() * ki.out_scale
        assert (got - ki.ref_fn(res.env).double()).abs().max() < 0.06

    def test_sftmx_equals_the_softmax_kernel(self, runs):
        """int_softmax's entry point computes the payload's function on
        these inputs (what phase 10 holds on the card)."""
        from repro_torch.core.kernel_library import SFTMX_SCALE
        _, env_in, _, res, _ = runs[0]["sftmx"]
        got = ops.softmax_i8(env_in["scores"], SFTMX_SCALE, env_in["mask"])
        assert torch.equal(got.to(torch.int32), res.env["out"])

    def test_norm_close_to_float(self, runs):
        ki, _, _, res, _ = runs[0]["norm"]
        got = res.env["out"].double() * res.env["out_scale"]
        assert (got - ki.ref_fn(res.env).double()).abs().max() < 0.15

    def test_quant_exact(self, runs):
        ki, _, _, res, _ = runs[0]["quant"]
        assert (res.env["out"].double() - ki.ref_fn(res.env)).abs().max() <= 1

    def test_conv_requant_of_exact_acc(self, runs):
        ki, _, _, res, _ = runs[0]["conv"]
        assert res.env["out"].shape == (8, 126, 126)
        ref_ki = runs[1]["conv"][0]
        assert np.array_equal(ki.ref_fn(res.env).numpy(),
                              ref_ki.ref_fn(runs[1]["conv"][3].env))

    def test_gelu_close(self, runs):
        ki, _, _, res, _ = runs[0]["gelu"]
        got = res.env["out"].reshape(4, 16).double() * res.env["out_scale"]
        assert (got - ki.ref_fn(res.env).double()).abs().max() < 0.2

    def test_cpu_run_launches_nothing(self, runs):
        assert runs[2] == {k: 0 for k in ops.KERNELS}


class TestTables:
    def test_area_table_equal(self):
        assert costmodel.area_table() == ref_cost.area_table()
        assert costmodel.TOTAL_AREA_MM2 == ref_cost.TOTAL_AREA_MM2
        assert costmodel.ACTIVE_W == ref_cost.ACTIVE_W
        assert costmodel.PAPER_TABLE_VI == ref_cost.PAPER_TABLE_VI
        assert abs(costmodel.TOTAL_AREA_MM2 - 0.178) < 0.001

    def test_table_ii_effective_mops_equal(self, runs):
        assert edge_models.EDGE_MODELS == ref_edge.EDGE_MODELS
        assert edge_models.KERNEL_INPUTS == ref_edge.KERNEL_INPUTS

        def eff(mets):
            out = {}
            for model, comp in edge_models.EDGE_MODELS.items():
                share = {k: v / 100.0 for k, v in comp.items() if v > 0}
                denom = sum(s / mets[k].mops for k, s in share.items())
                out[model] = sum(share.values()) / denom if denom else 0.0
            return out
        assert eff({k: v[4] for k, v in runs[0].items()}) == \
            eff({k: v[4] for k, v in runs[1].items()})

    def test_kernel_ordering_matches_paper(self, runs):
        mops = {k: v[4].mops for k, v in runs[0].items()}
        assert mops["gemm"] > mops["conv"] > mops["sftmx"]
        assert mops["gelu"] > mops["quant"] > mops["norm"]

    def test_within_calibration_band_and_power(self, runs):
        for name, v in runs[0].items():
            m = v[4]
            assert 1 / 3 < m.mops / costmodel.PAPER_TABLE_VI[name][0] < 3
            assert 0.8 < m.power_mw < 3.0


def test_builders_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in BUILDERS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
