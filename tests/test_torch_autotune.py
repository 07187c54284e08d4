"""The port's ``kernels/autotune.py``: the measured cache (the reference's
semantics: an exact key hit wins, ``record`` keeps the fastest, the default
file ``.autotune/measured.json``), the six choosers' tables at every served
shape of PERF.md §6 (equal, row by row, to ``torch_autotune_tables.json``:
the tilings the kernels launched with before the choosers existed), a
measured entry overriding the table, and the decode split read alike by
T = 1 and multi-row launches, dense and paged caches and every
tensor-parallel rank.  CPU only: no card, no kernel."""
import importlib.util
import inspect
import json
import os
from pathlib import Path

import pytest
import torch

from repro_torch.core import costmodel as cm
from repro_torch.kernels import autotune as at
from repro_torch.kernels import int8_kv_decode_attention as kd

ROOT = Path(__file__).resolve().parents[1]
SMS = 132


def _table_script():
    spec = importlib.util.spec_from_file_location(
        "autotune_table", ROOT / "scripts" / "autotune_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TABLE = _table_script()
# [family, shape, tiling] at each of TABLE's shapes as the rules of commit
# dc4417f gave them, before the choosers existed: int8_gemm.w8_tiling,
# w4_tiling and bf16_tiling, bf16_gemm.bf16_gemm_tiling and
# int8_kv_decode_attention.kv_split (the rules these tables moved from)
EARLIER_RULES = json.loads(
    (Path(__file__).with_name("torch_autotune_tables.json")).read_text())
FAMILIES = ("gemm_blocks", "gated_mlp_blocks int8", "gated_mlp_blocks bf16",
            "gemm_w4a8_blocks", "gatedmlp_w4a8_blocks", "bf16_gemm_blocks",
            "decode_blocks")


@pytest.fixture(autouse=True)
def cache(monkeypatch, tmp_path):
    """A measured cache of this test's own (missing until written)."""
    path = tmp_path / "measured.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    at.reset_measured_cache()
    yield path
    at.reset_measured_cache()


def test_default_cache_path(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert at.cache_path() == str(ROOT / ".autotune" / "measured.json")


def test_record_round_trip_keeps_the_fastest(cache):
    at.record("gemm/x", (16, 128, 2, 64), 5.0)
    assert json.loads(cache.read_text()) == {
        "gemm/x": {"blocks": [16, 128, 2, 64], "us": 5.0}}
    at.record("gemm/x", (64, 128, 1, 64), 7.0)      # slower: kept out
    at.reset_measured_cache()
    assert at._hit("gemm/x") == (16, 128, 2, 64)
    at.record("gemm/x", (64, 128, 1, 64), 3.0)      # faster: replaces
    at.reset_measured_cache()
    assert at._hit("gemm/x") == (64, 128, 1, 64)
    assert not os.path.exists(str(cache) + ".tmp")


def test_measure_records_the_fastest_candidate(cache):
    cands = at.mma_candidates("w8", 1, 8, 4096, 4096, SMS)
    times = {tuple(t[:4]): 10.0 + i for i, t in enumerate(cands)}
    slowest_first = sorted(times, key=times.get, reverse=True)
    fastest = slowest_first[-1]
    key = at.mma_key("gemm", 8, 4096, 4096, "int8", SMS)
    got = at.measure(key, slowest_first, lambda b: times[tuple(b)])
    assert got == fastest
    at.reset_measured_cache()
    assert at._hit(key) == fastest


@pytest.mark.parametrize("family", ["gemm", "gated_int8", "gated_bf16",
                                    "w4", "dual_w4", "bf16_gemm", "decode"])
def test_a_measured_entry_overrides_the_table(family, cache):
    """An exact key hit that is one of the shape's candidates wins over the
    table; the table comes back when the entry names a tiling the C entry
    does not take."""
    m, k, n, g = 8, 4096, 13440, 64
    choose, cands, key = {
        "gemm": (lambda: at.gemm_blocks(m, k, n, SMS),
                 at.mma_candidates("w8", 1, m, k, n, SMS),
                 at.mma_key("gemm", m, k, n, "int8", SMS)),
        "gated_int8": (lambda: at.gated_mlp_blocks(m, k, n, "int8", SMS),
                       at.mma_candidates("w8", 2, m, k, n, SMS),
                       at.mma_key("gatedmlp", m, k, n, "int8", SMS)),
        "gated_bf16": (lambda: at.gated_mlp_blocks(m, k, n, "bf16", SMS),
                       at.mma_candidates("bf16", 2, m, k, n, SMS),
                       at.mma_key("gatedmlp", m, k, n, "bf16", SMS)),
        "w4": (lambda: at.gemm_w4a8_blocks(m, k, n, g, SMS),
               at.mma_candidates("w4", 1, m, k, n, SMS, g),
               at.mma_key("gemm_w4a8", m, k, n, f"g{g}", SMS)),
        "dual_w4": (lambda: at.gatedmlp_w4a8_blocks(m, k, n, g, SMS),
                    at.mma_candidates("w4", 2, m, k, n, SMS, g),
                    at.mma_key("gatedmlp_w4a8", m, k, n, f"g{g}", SMS)),
        "bf16_gemm": (lambda: at.bf16_gemm_blocks(m, k, n, SMS),
                      at.bf16_gemm_candidates(m, k, n),
                      at.bf16_gemm_key(m, k, n, SMS)),
        "decode": (lambda: at.decode_blocks(16, 1024, 128, 12, SMS),
                   at.decode_candidates(16, 1024, SMS),
                   at.decode_key(16, 1024, 128, 12, SMS)),
    }[family]
    table = choose()
    assert table in cands
    other = next(c for c in cands if c != table)
    width = 2 if family == "decode" else 4
    at.record(key, tuple(other)[:width], 1.0)
    assert choose() == other
    at.reset_measured_cache()
    assert choose() == other
    cache.write_text(json.dumps({key: {"blocks": [999] * width, "us": 0.5}}))
    at.reset_measured_cache()
    assert choose() == table


@pytest.mark.parametrize("family", FAMILIES)
def test_tables_are_the_earlier_rules_at_every_served_shape(family):
    """With no measured cache the chooser gives, at every shape of PERF.md
    §6, the tiling the kernel launched with before the choosers existed
    (``EARLIER_RULES``, row by row), and its Hopper tile cost is finite
    and positive."""
    want = [(shape, tiling) for fam, shape, tiling in EARLIER_RULES
            if fam == family]
    got = [(list(shape), list(table), est(table))
           for fam, shape, table, _, est in TABLE.families() if fam == family]
    assert [s for s, _ in want] == [s for s, _, _ in got]
    assert want
    for (shape, tiling), (_, table, cost) in zip(want, got):
        assert table == tiling, f"{family} at {shape}"
        assert 0 < cost < 1, f"{family} at {shape}: {cost} s"


@pytest.mark.parametrize("form", ["gemm", "gated_int8", "gated_bf16", "w4",
                                  "dual_w4", "bf16_gemm"])
def test_every_table_choice_is_a_candidate(form):
    """The table's tiling is among the candidates the card times; the bf16
    forms never split K, and the integer splits cover K in whole stages (of
    the W4 group where larger)."""
    for fam, shape, table, _, _ in TABLE.families():
        if form == "gemm" and fam == "gemm_blocks":
            m, k, n, e = shape
            assert table in at.mma_candidates("w8", 1, m, k, n, -(-SMS // e))
        elif form == "gated_int8" and fam == "gated_mlp_blocks int8":
            m, k, n, e = shape
            assert table in at.mma_candidates("w8", 2, m, k, n, -(-SMS // e))
        elif form == "gated_bf16" and fam == "gated_mlp_blocks bf16":
            m, k, n, e = shape
            cands = at.mma_candidates("bf16", 2, m, k, n, -(-SMS // e))
            assert table in cands
            assert all(c.split == 1 and c.k_len == k for c in cands)
        elif form in ("w4", "dual_w4") and fam == {
                "w4": "gemm_w4a8_blocks",
                "dual_w4": "gatedmlp_w4a8_blocks"}[form]:
            m, k, n, g, e = shape
            streams = 1 if form == "w4" else 2
            cands = at.mma_candidates("w4", streams, m, k, n, -(-SMS // e), g)
            assert table in cands
            for c in cands:
                assert c.k_len % max(at.W4_BK, g) == 0
                assert (c.split - 1) * c.k_len < k <= c.split * c.k_len
        elif form == "bf16_gemm" and fam == "bf16_gemm_blocks":
            m, k, n = shape
            cands = at.bf16_gemm_candidates(m, k, n)
            assert table in cands and all(c.k_len == k for c in cands)


def test_the_decode_key_holds_no_row_count_and_no_rank(monkeypatch, cache):
    """``decode_blocks`` takes B x the full Hkv, the cache length, the head
    dim and G: no rows, no rank.  Driven through ``launch_rows`` (the
    entry a recorder), the T = 1 and T = 256 launches, the dense cache and
    a paged arena of the same slots, and each tp 2 / 4 rank's head shard
    (``split_hkv`` = the full Hkv) all take one split — the measured one
    once an entry exists."""
    assert list(inspect.signature(at.decode_blocks).parameters) == [
        "blocks", "s", "d", "g", "n_sm"]

    class Props:
        multi_processor_count = SMS
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    b, hq, hkv, d, s = 8, 32, 8, 128, 1024

    def splits():
        got = []
        for tp in (1, 2, 4):
            for t in (1, 256):
                q = torch.zeros((b, t, hq // tp, d), dtype=torch.bfloat16)
                qpos = torch.zeros((b, t), dtype=torch.int32)
                kv = torch.zeros(16, dtype=torch.int8)

                def entry(q, qpos, out, n_split, chunk, t, rows, part):
                    got.append((n_split, chunk))
                    return 0
                for slots in (s, 64 * 16):       # dense, 64 pages of 16
                    kd.launch_rows(entry, q, qpos, b, hkv // tp, slots,
                                   (kv, kv), split_hkv=hkv)
        return got

    table = splits()
    assert set(table) == {at.decode_blocks(b * hkv, s, d, hq // hkv, SMS)}
    other = next(c for c in at.decode_candidates(b * hkv, s, SMS)
                 if c != table[0])
    at.record(at.decode_key(b * hkv, s, d, hq // hkv, SMS), other, 1.0)
    assert set(splits()) == {other}


def test_moe_and_tp_tables_ignore_the_measured_cache(cache):
    """``moe_group_size`` and ``tp_serving_overlap`` are tables only: a
    ``moe/...`` entry (the reference's key, which its benchmark writes into
    the shared file) or a ``tpserve/...`` one moves neither."""
    table = at.moe_group_size(4096, 4096, 14336, 8, 2, 1.25)
    choice = at.tp_serving_overlap(8, 4096, 13440, 4096, 2)
    at.record("moe/4096x4096x14336/8x2x1.25",
              (128 if table != 128 else 256,), 1.0)
    for key in ("tpserve/8x4096x13440x4096/tp2",
                "tpserve/8x4096x13440x4096/tp2/cuda"):
        at.record(key, (0 if choice == "overlap" else 1,), 1.0)
    at.reset_measured_cache()
    assert at.moe_group_size(4096, 4096, 14336, 8, 2, 1.25) == table
    assert at.tp_serving_overlap(8, 4096, 13440, 4096, 2) == choice


def test_hopper_costs_follow_waves_and_bytes():
    """The tile costs move as their terms say: a byte-bound decode GEMM
    costs about its weight bytes at 3.35 TB/s; splitting K past the fill of
    the card only adds combine bytes; a bf16 tile that leaves SMs idle
    costs a whole wave."""
    weight_s = 13440 * 4096 / cm.H100_HBM_BPS
    t = at.gemm_blocks(8, 13440, 4096, SMS)
    est = cm.mma_gemm_tile_cost(8, 13440, 4096, "w8", 1, t.bm, t.bn, t.split,
                                t.k_len, 1)
    assert weight_s < est < 3 * weight_s
    more = at.split_k(8, 4096, 13440, SMS, bm=16, want=8 * SMS)
    assert cm.mma_gemm_tile_cost(8, 13440, 4096, "w8", 1, 16, 128, *more,
                                 1) > est
    one = cm.bf16_gemm_tile_cost(4096, 4096, 4096, 128, 256, 4, 128)
    assert cm.bf16_gemm_tile_cost(4096, 4096, 4096 + 256, 128, 256, 4,
                                  128) > one
