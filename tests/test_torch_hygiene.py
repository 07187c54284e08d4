"""Ground rules of the PyTorch/CUDA port that no parity test sees:

* no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports ``jax``
  or the ``repro`` package (an AST scan);
* entry points run on the card unless the caller asks for the CPU, and
  raise — never fall back — when no card is present;
* every kernel is CUDA C++ under ``kernels/csrc`` built for ``sm_90a``
  without fast math, and a CPU tensor takes its plain version.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params, init_states
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax"}
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_whole_port():
    files = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for need in ("models/layers.py", "models/attention.py", "models/lm.py",
                 "kernels/ops.py", "serve/engine.py", "launch/serve.py",
                 "convert.py", "quant/ptq.py", "core/inumerics.py",
                 "serve/kv_pool.py", "kernels/paged_attention.py",
                 "kernels/int_softmax.py", "kernels/int8_flash_attention.py",
                 "kernels/flash_attention.py", "kernels/int_gelu.py",
                 "kernels/int_silu.py", "kernels/conv2d.py",
                 "models/frontend.py", "models/ssm.py", "models/blocks.py",
                 "kernels/ssd_scan.py", "configs/zamba2_2_7b.py",
                 "serve/prng.py", "serve/draft.py", "models/moe.py",
                 "core/costmodel.py", "kernels/autotune.py",
                 "configs/mixtral_8x7b.py", "configs/qwen2_moe_a2_7b.py",
                 "models/encdec.py", "configs/whisper_small.py",
                 "configs/llama_3_2_vision_90b.py", "train/trainer.py",
                 "train/optimizer.py", "train/checkpoint.py",
                 "data/pipeline.py", "dist/compression.py",
                 "launch/train.py", "core/isa.py", "core/program.py",
                 "core/scheduler.py", "core/simulator.py",
                 "core/kernel_library.py", "configs/edge_models.py",
                 "kernels/bf16_gemm.py"):
        assert need in files


def _exported(init: Path) -> set[str]:
    """The names a package's ``__init__.py`` imports (AST only: the
    reference's package is not imported)."""
    return {a.asname or a.name
            for node in ast.walk(ast.parse(init.read_text()))
            if isinstance(node, ast.ImportFrom) for a in node.names}


@pytest.mark.parametrize("pkg", ["models", "serve", "train", "data", "core"])
def test_packages_export_what_the_references_export(pkg):
    import importlib
    mod = importlib.import_module(f"repro_torch.{pkg}")
    want = _exported(ROOT / "src" / "repro" / pkg / "__init__.py")
    assert want and not {n for n in want if not hasattr(mod, n)}
    assert want <= set(mod.__all__)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda):
    cfg = get_config("starcoder2-3b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 8)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, ServeConfig(max_seq=16, token_budget=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, device="cuda")


def test_explicit_cpu_runs_and_launches_nothing():
    cfg = get_config("starcoder2-3b", precision="w8a8", reduced=True)
    from repro_torch.quant import ptq_quantize_params
    params = ptq_quantize_params(init_params(cfg, seed=1, device="cpu"))
    eng = ServingEngine(params, cfg, ServeConfig(batch_lanes=2, max_seq=32,
                                                 int8_kv=True, token_budget=4),
                        device="cpu")
    ops.reset_launch_counts()
    eng.submit([5, 6, 7], max_new=3)
    (rec,) = eng.run_until_drained()
    assert len(rec["tokens"]) >= 1
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_explicit_cpu_w4a8_launches_nothing():
    from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
    cfg = get_config("codeqwen1.5-7b", precision="w4a8", reduced=True)
    params = ptq_quantize_params(init_params(cfg, seed=1, device="cpu"),
                                 policy=DEFAULT_W4_POLICY)
    assert params.layers[0].mlp.w_gate.int4 and not params.unembed.int4
    eng = ServingEngine(params, cfg, ServeConfig(batch_lanes=2, max_seq=32,
                                                 int8_kv=True, token_budget=4),
                        device="cpu")
    ops.reset_launch_counts()
    eng.submit([5, 6, 7], max_new=3)
    (rec,) = eng.run_until_drained()
    assert len(rec["tokens"]) >= 1
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert {"int4_gemm", "dual_int4_gemm_gated", "dual_gemm_gated",
            "paged_decode_attention"} <= set(ops.KERNELS)


@pytest.mark.parametrize("precision,mlp,head", [
    ("w4a8", "int4", "int8"), ("w8a8", "int8", "int8"),
    ("bf16", "float", "float")])
def test_quantize_for_picks_the_launchers_policy(precision, mlp, head):
    from repro_torch.quant import quantize_for

    def form(lin):
        return "int4" if lin.int4 else "int8" if lin.quantized else "float"
    cfg = get_config("codeqwen1.5-7b", precision=precision, reduced=True)
    params = quantize_for(init_params(cfg, seed=1, device="cpu"), precision)
    layer = params.layers[0]
    assert {form(layer.attn.wq), form(layer.attn.wo), form(layer.mlp.w_in),
            form(layer.mlp.w_gate), form(layer.mlp.w_out)} == {mlp}
    assert form(params.unembed) == head
    with pytest.raises(ValueError, match="precision"):
        quantize_for(params, "fp8")


def test_codeqwen_is_ported():
    from repro_torch.configs import ARCH_IDS
    assert "codeqwen1.5-7b" in ARCH_IDS
    cfg = get_config("codeqwen1.5-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (32, 4096, 32, 32, 13440, 92416)


def test_launcher_cpu_w4a8(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "codeqwen1.5-7b", "--reduced", "--w4a8", "--int8-kv",
          "--requests", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "precision=w4a8" in out


def test_launcher_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "starcoder2-3b", "--reduced", "--w8a8", "--int8-kv",
          "--requests", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "mode=packed" in out


def test_explicit_cpu_paged_launches_nothing():
    from repro_torch.quant import DEFAULT_W4_POLICY, ptq_quantize_params
    cfg = get_config("codeqwen1.5-7b", precision="w4a8", reduced=True)
    params = ptq_quantize_params(init_params(cfg, seed=1, device="cpu"),
                                 policy=DEFAULT_W4_POLICY)
    eng = ServingEngine(params, cfg, ServeConfig(batch_lanes=2, max_seq=32,
                                                 int8_kv=True, token_budget=4,
                                                 paged=True),
                        device="cpu")
    assert eng.paged and eng._pt.device.type == "cpu"
    ops.reset_launch_counts()
    eng.submit([5, 6, 7], max_new=3)
    (rec,) = eng.run_until_drained()
    assert len(rec["tokens"]) >= 1
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_paged_engine_defaults_to_the_card(no_cuda):
    cfg = get_config("starcoder2-3b", reduced=True)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, ServeConfig(max_seq=16, token_budget=4,
                                               paged=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 16, paged_pages=4, page_size=8)


def test_kernel_sources_and_flags():
    assert {"paged_decode_attention", "int_softmax", "int8_flash_attention",
            "flash_attention", "int_gelu", "int_silu", "requantize",
            "int8_conv2d", "ssd_scan"} <= set(build.SOURCES)
    # quantize.cu holds quantize_rows, requantize.cu requantize_i32
    assert set(build.SOURCES) <= set(ops.KERNELS) | {"quantize", "requantize"}
    # the sixteen Pallas kernels' ports, then the one the port adds
    assert len(ops.TPU_KERNELS) == 16
    assert ops.KERNELS == ops.TPU_KERNELS + ("bf16_gemm",)
    for name in build.SOURCES:
        src = build.CSRC / f"{name}.cu"
        assert src.exists()
        assert 'extern "C"' in src.read_text()
    flags = " ".join(build.FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert build.build_dir().parts[-2:] == ("build", "kernels") or \
        os.environ.get("REPRO_TORCH_BUILD_DIR")
    assert "build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("precision", ["bf16", "w8a8", "w4a8"])
def test_explicit_cpu_no_cache_launches_nothing(precision):
    from repro_torch.models import lm_loss
    from repro_torch.quant import quantize_for
    cfg = get_config("codeqwen1.5-7b", precision=precision, reduced=True)
    params = quantize_for(init_params(cfg, seed=1, device="cpu"), precision)
    toks = torch.randint(2, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    loss = lm_loss(params, cfg, toks[:, :-1], toks[:, 1:])
    assert torch.isfinite(loss) and loss.dim() == 0
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _no_cache_calls():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_flash_attention as ia
    from repro_torch.kernels import int_softmax as sm
    i8 = torch.zeros((1, 2, 8, 16), dtype=torch.int8)
    bf = torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16)
    vs = torch.ones((1, 2, 8, 1))
    return [(sm, lambda: ops.softmax_i8(torch.zeros((4, 8), dtype=torch.int32),
                                        0.05)),
            (ia, lambda: ops.attention_i8(i8, i8, i8, 1 / 256, v_scale=vs)),
            (fa, lambda: ops.attention(bf, bf, bf))]


@pytest.mark.parametrize("which", range(3))
def test_no_cache_wrappers_never_fall_back(monkeypatch, which):
    """With the tensors taken for CUDA ones, each new wrapper goes to its
    kernel — here the build, which raises — and not to the plain version."""
    mod, call = _no_cache_calls()[which]
    monkeypatch.setattr(mod, "on_cuda", lambda *a: True)

    def no_build(*a, **k):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        call()


def _int_library_calls():
    from repro_torch.core.inumerics import RequantParams
    from repro_torch.kernels import conv2d, int8_gemm, int_gelu, int_silu
    from repro_torch.kernels import quantize
    from repro_torch.models import layers
    rq = RequantParams(s1=2, mult=9000, s2=14)
    x32 = torch.zeros((4, 8), dtype=torch.int32)
    i8 = torch.zeros((4, 8), dtype=torch.int8)
    img = torch.zeros((1, 5, 5, 3), dtype=torch.int8)
    filt = torch.zeros((3, 3, 3, 4), dtype=torch.int8)
    bias = torch.zeros(4, dtype=torch.int32)
    mode = layers.ExecMode("w8a8")
    h = torch.zeros((2, 8), dtype=torch.bfloat16)
    return [(quantize, lambda: ops.requant(x32, rq)),
            (int_gelu, lambda: ops.gelu_i8(x32, 0.05)),
            (int_silu, lambda: ops.silu_i8(x32, 0.05)),
            (int8_gemm, lambda: ops.gemm_i8(i8, i8.T.contiguous(), rq)),
            (int8_gemm, lambda: ops.gemm_i8_gelu(i8, i8.T.contiguous(), 0.05)),
            (int8_gemm, lambda: ops.gemm_i8_add(i8, i8.T.contiguous(), rq,
                                                i8[:, :4].contiguous())),
            (conv2d, lambda: ops.conv2d_i8(img, filt, bias, rq)),
            (int_gelu, lambda: layers.activation(h, "gelu", mode)),
            (int_silu, lambda: layers.activation(h, "silu", mode))]


@pytest.mark.parametrize("which", range(9))
def test_int_library_wrappers_never_fall_back(monkeypatch, which):
    """With the tensors taken for CUDA ones, each wrapper of the integer
    library — and ``layers.activation``'s integer branch, which raised on
    the card before it had a kernel — goes to its kernel (here the build,
    which raises), never to the plain version."""
    import types
    from repro_torch.kernels import common
    mod, call = _int_library_calls()[which]
    monkeypatch.setattr(mod, "on_cuda", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *a:
                        types.SimpleNamespace(multi_processor_count=132))

    def no_build(*a, **k):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)
    monkeypatch.setattr(common.build, "entry", no_build)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        call()


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "starcoder2-3b"])
def test_explicit_cpu_mixed_forward_launches_nothing(arch):
    """The integer-nonlinearity forward (a w8a8 config over float
    parameters) on the CPU: its integer activation, norms and attention
    take their plain versions."""
    from repro_torch.models import lm_loss
    cfg = get_config(arch, precision="w8a8", reduced=True)
    params = init_params(cfg, seed=1, device="cpu")
    toks = torch.randint(2, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    loss = lm_loss(params, cfg, toks[:, :-1], toks[:, 1:])
    assert torch.isfinite(loss) and loss.dim() == 0
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_decode_attentions_share_one_body():
    """The dense and paged decode attentions are one body (so paged ==
    dense bit for bit by construction): each source only names where key j
    lives and defines no kernel of its own."""
    for name in ("int8_kv_decode_attention", "paged_decode_attention"):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "decode_tile.cuh"' in src
        assert "__global__" not in src and "decode::launch<" in src


# ---------------------------------------------------------------------------
# zamba2-2.7b: the Mamba-2 path (ssd_scan) and the multi-row decode form
# ---------------------------------------------------------------------------

def test_zamba2_entry_points_default_to_the_card(no_cuda):
    from repro_torch.convert import from_reference, to_reference
    cfg = get_config("zamba2-2.7b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 8)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(to_reference(params, cfg), cfg)


def test_serving_zamba2_names_the_tokenwise_schedule():
    """Recurrent archs serve tokenwise (§A1): zamba2 on the CPU, with a
    token budget asked for, names the tokenwise schedule, serves one token
    per lane a step and launches nothing."""
    from repro_torch.quant import quantize_for
    cfg = get_config("zamba2-2.7b", precision="w8a8", reduced=True)
    params = quantize_for(init_params(cfg, seed=1, device="cpu"), "w8a8")
    eng = ServingEngine(params, cfg, ServeConfig(max_seq=16, token_budget=4,
                                                 int8_kv=True, batch_lanes=2),
                        device="cpu")
    assert eng.mode == "tokenwise" and eng.chunk_buckets == ()
    ops.reset_launch_counts()
    eng.submit([5, 6, 7], max_new=3)
    (rec,) = eng.run_until_drained()
    assert len(rec["tokens"]) == 3 and set(eng.stats["forwards"]) == {1}
    assert "mode=tokenwise" in eng.stats_summary()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("precision", ["bf16", "w8a8", "w4a8"])
def test_explicit_cpu_zamba2_launches_nothing(precision):
    """zamba2's no-cache lm_loss and its forward with states (a t > 1
    prefill, then a t == 1 step) on the CPU take every plain version."""
    from repro_torch.models import forward, lm_loss
    from repro_torch.quant import quantize_for
    cfg = get_config("zamba2-2.7b", precision=precision, reduced=True)
    params = quantize_for(init_params(cfg, seed=1, device="cpu"), precision)
    toks = torch.randint(2, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(0))
    ops.reset_launch_counts()
    loss = lm_loss(params, cfg, toks[:, :-1], toks[:, 1:])
    st = init_states(cfg, 2, 32, int8_kv=precision != "bf16", device="cpu")
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    lg, st = forward(params, cfg, toks[:, :16], pos, st)
    lg, st = forward(params, cfg, lg[:, -1:].argmax(-1), pos[:, -1:] + 1, st)
    assert torch.isfinite(loss) and torch.isfinite(lg).all()
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _no_build(monkeypatch):
    import types

    def no_build(*a, **k):
        raise RuntimeError("no nvcc here")
    monkeypatch.setattr(build, "entry", no_build)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *a:
                        types.SimpleNamespace(multi_processor_count=132))


def test_ssd_scan_never_falls_back(monkeypatch):
    """With the tensors taken for CUDA ones, ``ops.ssd_scan`` and the
    Mamba-2 block's t > 1 branch go to the kernel — here the build, which
    raises — never to the plain version."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.models import ssm
    from repro_torch.models.layers import ExecMode
    monkeypatch.setattr(ssd_scan, "on_cuda", lambda *a: True)
    _no_build(monkeypatch)
    x, dt, a = torch.zeros(1, 128, 2, 64), torch.ones(1, 128, 2), -torch.ones(2)
    bm = torch.zeros(1, 128, 16)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        ops.ssd_scan(x, dt, a, bm, bm)
    cfg = get_config("zamba2-2.7b", reduced=True)
    block = init_params(cfg, device="cpu").layers[0].mamba
    with pytest.raises(RuntimeError, match="no nvcc here"):
        ssm.mamba2(block, torch.zeros(1, 5, cfg.d_model, dtype=torch.bfloat16),
                   cfg, ExecMode("bf16"))


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_rows_take_the_multi_row_form(monkeypatch, paged, t):
    """On the card (``_card_route`` taken for true, the decode wrappers'
    tensors for CUDA ones) a step against an int8 cache, t = 1 or t > 1,
    reaches the decode kernels' multi-row form — here the build, which
    raises — and never ``_sdpa``."""
    from repro_torch.kernels import int8_kv_decode_attention as dense_mod
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import forward

    def no_sdpa(*a, **k):
        raise AssertionError("a cache row took _sdpa on the card")
    cfg = get_config("codeqwen1.5-7b", precision="w8a8", reduced=True)
    from repro_torch.quant import quantize_for
    params = quantize_for(init_params(cfg, seed=1, device="cpu"), "w8a8")
    kw = dict(paged_pages=9, page_size=8) if paged else {}
    st = init_states(cfg, 2, 32, int8_kv=True, device="cpu", **kw)
    if paged:
        st[0]["kv"]["pt"].copy_(torch.arange(1, 9, dtype=torch.int32
                                             ).reshape(2, 4))
    monkeypatch.setattr(attn_mod, "_card_route", lambda *a: True)
    monkeypatch.setattr(attn_mod, "_sdpa", no_sdpa)
    monkeypatch.setattr(dense_mod, "on_cuda", lambda *a: True)
    monkeypatch.setattr(paged_mod, "on_cuda", lambda *a: True)
    _no_build(monkeypatch)
    pos = torch.arange(t, dtype=torch.int32).expand(2, t)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        forward(params, cfg, torch.full((2, t), 5), pos, st)


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-moe-a2.7b"])
def test_moe_archs_are_ported_and_default_to_the_card(arch, no_cuda):
    from repro_torch.configs import ARCH_IDS
    assert arch in ARCH_IDS
    cfg = get_config(arch, precision="w4a8", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, precision="w4a8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_states(cfg, 1, 16, window_slack=4)


@pytest.mark.parametrize("arch,flag", [("mixtral-8x7b", "--w4a8"),
                                       ("qwen2-moe-a2.7b", "--w8a8")])
@pytest.mark.parametrize("paged", [False, True])
def test_launcher_cpu_moe(capsys, arch, flag, paged):
    from repro_torch.launch.serve import main
    ops.reset_launch_counts()
    main(["--arch", arch, "--reduced", flag, "--int8-kv", "--requests", "2",
          "--max-new", "3", "--device", "cpu"] + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert "served 2 requests" in out and ("paged pool:" in out) == paged
    assert ops.launch_counts(forms=True) == {
        k: 0 for k in ops.KERNELS + ops.FORMS}


def test_expert_batched_entries():
    """The four GEMM sources take the expert count first: one launch over
    every expert of a MoE layer (``Slice`` in ``gemm_mma.cuh``)."""
    assert "struct Slice" in (build.CSRC / "gemm_mma.cuh").read_text()
    for name, entries in (("int8_gemm", ["repro_int8_gemm"]),
                          ("int4_gemm", ["repro_int4_gemm"]),
                          ("dual_gemm_gated", ["repro_dual_gemm_gated_i8",
                                               "repro_dual_gemm_gated_bf16"]),
                          ("dual_int4_gemm_gated",
                           ["repro_dual_int4_gemm_gated"])):
        text = " ".join((build.CSRC / f"{name}.cu").read_text().split())
        text = text.replace("( ", "(")
        for entry in entries:
            assert f"{entry}(int experts," in text
        assert f"{name}.experts" in ops.FORMS


# ---------------------------------------------------------------------------
# gradients: the kernels under autograd, and no silent detach elsewhere
# ---------------------------------------------------------------------------

GRAD_CASES = ["flash_attention", "dual_gemm_gated_bf16", "ssd_scan",
              "dual_gemm_gated_experts_bf16"]


def _grad_kernel(which):
    """(module, the name its launch goes by, a fake launch computing the
    plain version and counting, inputs, the call, the plain version of the
    call, the kernel's count) of ``GRAD_CASES[which]``.  The scan's call
    keeps y only: the final state is unused, so its Function's backward
    gets None for it."""
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_gemm as ig
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator().manual_seed(which)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dtype)
    if which == 0:
        def launch(q, k, v, causal, scale):
            common.LAUNCHES["flash_attention"] += 1
            return fa.flash_attention_ref(q, k, v, causal, scale)
        ins = [rand(2, 4, 16, 16), rand(2, 2, 16, 16), rand(2, 2, 16, 16)]
        return (fa, "_launch", launch, ins, lambda *a: ops.attention(*a),
                lambda *a: fa.flash_attention_ref(*a), "flash_attention")
    if which == 2:
        def launch_scan(xh, dt, A, Bm, Cm):
            common.LAUNCHES["ssd_scan"] += 1
            return ss.ssd_scan_ref(xh, dt, A, Bm, Cm)
        f32 = torch.float32
        ins = [rand(2, 128, 2, 64, dtype=f32),
               torch.nn.functional.softplus(rand(2, 128, 2, dtype=f32)),
               -torch.exp(rand(2, dtype=f32)), rand(2, 128, 16, dtype=f32),
               rand(2, 128, 16, dtype=f32)]
        return (ss, "_launch", launch_scan, ins,
                lambda *a: ops.ssd_scan(*a)[0],
                lambda *a: ss.ssd_scan_ref(*a)[0], "ssd_scan")

    def launch_dual(x, w_up, w_gate, xs, us, gs, act, act_scale):
        common.LAUNCHES["dual_gemm_gated"] += 1
        return ig.per_expert(lambda *a: ig.gated_mlp_ref(*a, act), x, w_up,
                             w_gate)
    if which == 3:
        ins = [rand(3, 8, 32), rand(3, 32, 48), rand(3, 32, 48)]
        return (ig, "_launch_dual", launch_dual, ins,
                lambda *a: ops.gated_mlp_experts(*a, "silu"),
                lambda *a: ig.per_expert(
                    lambda *b: ig.gated_mlp_ref(*b, "silu"), *a),
                "dual_gemm_gated")
    ins = [rand(24, 32), rand(32, 48), rand(32, 48)]
    return (ig, "_launch_dual", launch_dual, ins,
            lambda *a: ops.gated_mlp(*a, "silu"),
            lambda *a: ig.gated_mlp_ref(*a, "silu"), "dual_gemm_gated")


@pytest.mark.parametrize("which", range(len(GRAD_CASES)), ids=GRAD_CASES)
def test_grad_kernels_launch_once_and_backward_is_plain(monkeypatch, which):
    """With the tensors taken for CUDA ones and the launch replaced by the
    plain version, the Function launches once in the forward and never in
    the backward, and its input gradients equal autograd of the plain
    version bit for bit (the scan's with its unused final state)."""
    mod, name, launch, ins, call, plain, kernel = _grad_kernel(which)
    monkeypatch.setattr(mod, "on_cuda", lambda *a: True)
    monkeypatch.setattr(mod, name, launch)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    out = call(*leaves)
    assert ops.launch_counts()[kernel] == 1
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                       ).to(out.dtype)
    got = torch.autograd.grad(out, leaves, dout)
    assert ops.launch_counts()[kernel] == 1
    ref_leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(plain(*ref_leaves), ref_leaves, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a leaf that needs no gradient gets none
    leaves[1].requires_grad_(False)
    assert torch.autograd.grad(call(*leaves), leaves[0], dout)[0] is not None


def _grad_refusals():
    """kernel -> a call of its wrapper whose float inputs pass through
    ``g`` (requantize_i32 takes int32 payloads only: nothing of it can
    require grad)."""
    from repro_torch.core.inumerics import RequantParams
    i8 = torch.zeros((4, 8), dtype=torch.int8)
    bf = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    x, dt, a = torch.zeros(1, 128, 2, 64), torch.ones(1, 128, 2), -torch.ones(2)
    bm = torch.zeros(1, 128, 16)
    e8 = torch.zeros((2, 4, 8), dtype=torch.int8)
    x64 = torch.zeros((2, 4, 64), dtype=torch.int8)
    w4 = torch.zeros((2, 32, 8), dtype=torch.int8)      # K = 64, group 32
    mul = torch.ones((2, 2, 8), dtype=torch.int8)
    return {"ssd_scan": lambda g: ops.ssd_scan(g(x), dt, a, bm, bm),
            "dual_gemm_gated_experts": lambda g: ops.gated_mlp_experts(
                g(bf), bf.transpose(1, 2).contiguous(),
                bf.transpose(1, 2).contiguous()),
            "int8_gemm_experts": lambda g: ops.gemm_w8a8_experts(
                e8, g(torch.ones(2, 4, 1)), e8.transpose(1, 2).contiguous(),
                torch.ones(2, 4)),
            "dual_int4_gemm_gated_experts":
                lambda g: ops.gated_mlp_w4a8_experts(
                    x64, g(torch.ones(2, 4, 1)), w4, mul, torch.ones(2, 8),
                    w4, mul, torch.ones(2, 8), act_scale=1.0),
            "quantize_rows": lambda g: ops.quant_rows(g(bf[0])),
            "int8_gemm": lambda g: ops.gemm_w8a8(
                i8, g(torch.ones(4, 1)), i8.T.contiguous(), torch.ones(4)),
            "int_layernorm_rows": lambda g: ops.norm_quant_rows(
                g(bf[0]), torch.ones(8, dtype=torch.int32),
                torch.zeros(8, dtype=torch.int32), torch.tensor(1.0)),
            "bf16_gemm": lambda g: ops.gemm_bf16(
                g(bf[0]), bf[1].transpose(0, 1).contiguous()),
            "requantize_i32": lambda g: ops.requant(
                torch.zeros(4, 8, dtype=torch.int32),
                RequantParams(s1=2, mult=9000, s2=14))}


@pytest.mark.parametrize("kernel", list(_grad_refusals()))
def test_other_kernels_refuse_inputs_that_require_grad(monkeypatch, kernel):
    """On the card (the inputs' device taken for CUDA) every wrapper outside
    ``GRAD_KERNELS`` raises, naming the kernel, on an input that requires
    grad while grad mode is on — the launch would drop the gradient; one of
    ``GRAD_KERNELS`` (ssd_scan, the expert-batched bf16 gated MLP) carries
    it into its Function's launch (the build, which raises).  Under
    ``torch.no_grad``, or with no input that requires grad, every wrapper
    goes to its kernel."""
    from repro_torch.kernels import common
    call = _grad_refusals()[kernel]
    monkeypatch.setattr(common, "tensor_device",
                        lambda t: torch.device("cuda", 0))
    _no_build(monkeypatch)

    def req(t):
        return t.clone().requires_grad_()
    if kernel in common.GRAD_KERNELS:
        with pytest.raises(RuntimeError, match="no nvcc here"):
            call(req)
    elif kernel != "requantize_i32":
        with pytest.raises(RuntimeError, match=f"^{kernel}: an input "
                           f"requires grad"):
            call(req)
    with torch.no_grad(), pytest.raises(RuntimeError, match="no nvcc here"):
        call(req)
    with pytest.raises(RuntimeError, match="no nvcc here"):
        call(lambda t: t)


def test_grad_kernels_pass_the_check(monkeypatch):
    """The flash_attention, ssd_scan and bf16 gated-MLP wrappers (unbatched
    and expert-batched) reach their kernels with inputs that require grad
    (inside their Functions)."""
    from repro_torch.kernels import common
    monkeypatch.setattr(common, "tensor_device",
                        lambda t: torch.device("cuda", 0))
    _no_build(monkeypatch)
    for which in range(len(GRAD_CASES)):
        *_, ins, call, _, _ = _grad_kernel(which)
        with pytest.raises(RuntimeError, match="no nvcc here"):
            call(*[t.requires_grad_() for t in ins])


def test_training_entry_points_default_to_the_card(no_cuda, tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train import CheckpointManager, TrainConfig, Trainer
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(), params)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "codeqwen1.5-7b", "--reduced",
                           "--steps", "1"])
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(1, {"w": torch.ones(2)})
