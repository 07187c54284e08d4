#!/usr/bin/env python3
"""Probes behind the port's tile and pipeline choices, on one NVIDIA card.

    python3 scripts/chip_probe.py tiles    # int8_gemm's tilings
    python3 scripts/chip_probe.py decode   # variants of the decode body
    python3 scripts/chip_probe.py ablate   # where int8_flash_attention's
                                           # and ssd_scan's time goes
    python3 scripts/chip_probe.py conv     # int8_conv2d's tilings and
                                           # int_softmax's forms

``tiles`` times int8_gemm (the ``scaled`` epilogue, GELU on starcoder2-3b's
up-projection) at starcoder2-3b's and codeqwen1.5-7b's W8A8 projections and
codeqwen1.5-7b's f32 head, with the tiling forced: 16-row decode blocks
against one 64-row block for M = 16 to 128, 64 x 128 against 128 x 128
blocks at M = 256 and 4096.  Every tiling's output must equal the first
one's.  ``autotune``'s int8_gemm table keeps what it decided.

``decode`` rebuilds ``csrc/decode_tile.cuh`` with other constants (threads a
block, tiles a round, tiles in the copy ring, the blocks an SM its launch
bounds ask for) into ``build/probe_decode/`` and times each
at codeqwen1.5-7b's (G = 1) and starcoder2-3b's (G = 12) heads over 8 lanes
of 1024 slots, at T = 1 and in the T = 256 multi-row form; every variant's
output must equal the committed source's.

``ablate`` rebuilds ``csrc/int8_flash_attention.cu``, ``csrc/ssd_scan.cu``,
``csrc/int_softmax.cu`` and ``csrc/int8_conv2d.cu`` with one part of the
work taken out (``ABLATIONS``: a textual edit of the source each) into
``build/probe_ablate/`` and times every CUDA kernel of a call under
torch.profiler (ten calls, no timer floor): int8_flash_attention at
codeqwen1.5-7b's [4, 32, 1024, 128] with v_scale and in its int32 form,
ssd_scan at zamba2-2.7b's [4, 1024, 80] x (64, 64), int_softmax on
[4096, 1024] int32 rows without and with the broadcast causal mask,
int8_conv2d at the ViT-B/16 patch embed and the 3x3 conv over 64 channels.  An ablated variant's
output is wrong by design; ``full`` (no edit) must equal the committed
build's output.

``conv`` times int8_conv2d with each block shape of ``conv2d.CONFIGS``
forced, at chip_smoke's phase 3 shapes (Table II, the 3x3 conv over 64
channels, the first layer over RGB, the ViT-B/16 patch embed), and
int_softmax with each form that holds a row of 1024 forced (1, 2, 4 or 8
warps a row) at [4096, 1024] int32, with and without the causal mask.
Every tiling's and form's output must equal the first one's.  It also
times the timer's floor (two events with nothing between them, and an
empty kernel) and the committed rules with the L2 flushed by a read, whose
clean lines cost nothing to evict, beside ``chip_smoke.Timer``'s written
flush.
``conv2d.tiling`` and ``int_softmax.form`` keep what it decided.

Times: CUDA events over ten launches with a cold L2 (``chip_smoke.Timer``).
Prints one line a shape or variant; needs nvcc and one card.
"""
from __future__ import annotations

import ctypes
import shutil
import types
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def tiles() -> None:
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import GELU_INT_SCALE, quantize_weight
    forced = {}

    def gemm_blocks(m, k, n, n_sm):
        bm = forced["bm"]
        return at._mma_table(m, n, k, at.W8_BK, n_sm, 1,
                             m if bm == 16 else 0, bm)
    at.gemm_blocks = gemm_blocks
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn, timer = cs.randn_on(dev, gen), cs.Timer(dev)
    for name, k, n, gs in (("starcoder q_proj", 3072, 3072, None),
                           ("starcoder kv_proj", 3072, 256, None),
                           ("starcoder mlp_up+gelu", 3072, 12288, GELU_INT_SCALE),
                           ("starcoder mlp_down", 12288, 3072, None),
                           ("codeqwen q_proj", 4096, 4096, None),
                           ("codeqwen mlp_down", 13440, 4096, None),
                           ("codeqwen head_f32", 4096, 92416, None)):
        wd = quantize_weight(randn(k, n, scale=k ** -0.5))
        od = torch.float32 if "head" in name else torch.bfloat16
        for m, bms in ((16, (16, 64)), (32, (16, 64)), (48, (16, 64)),
                       (64, (16, 64)), (128, (16, 64)), (256, (64, 128)),
                       (4096, (64, 128))):
            x_q, x_s = quantize_rows_ref(randn(m, k))
            ref, line = None, []
            for bm in bms:
                forced["bm"] = bm

                def run():
                    return ops.gemm_w8a8(x_q, x_s, wd["w_q"], wd["scale"],
                                         gelu_scale=gs, out_dtype=od)
                out = run()
                if ref is None:
                    ref = out
                elif not torch.equal(out, ref):
                    raise AssertionError(f"{name} M={m}: bm={bm} differs")
                split = gemm_blocks(m, k, n, 132).split
                line.append(f"bm={bm} (split {split}) {timer(run):.5f} ms")
            print(f"{name:22s} M={m:5d}: " + " | ".join(line), flush=True)
        del wd
        torch.cuda.empty_cache()


# the decode body's variants: name -> (threads, tiles a round, tiles in the
# ring, copy items a thread, blocks an SM its launch bounds ask for);
# "committed" is the source as it stands
DECODE_VARIANTS = {"committed": (256, 2, 4, 3, 3), "bounds1": (256, 2, 4, 3, 1),
                   "stages6": (256, 2, 6, 3, 3), "round4": (256, 4, 8, 3, 3),
                   "threads128": (128, 2, 4, 5, 3)}


def build_variant(name, cfg):
    from repro_torch.kernels import build
    threads, nr, stages, maxi, mb = cfg
    work = ROOT / "build/probe_decode" / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src/repro_torch/kernels/csrc", work)
    t = (work / "decode_tile.cuh").read_text()
    for old, new in (("constexpr int THREADS = 256,", f"constexpr int THREADS = {threads},"),
                     ("constexpr int NR = 2;", f"constexpr int NR = {nr};"),
                     ("constexpr int STAGES = 4;", f"constexpr int STAGES = {stages};"),
                     ("constexpr int MAXI = 3;", f"constexpr int MAXI = {maxi};"),
                     ("__launch_bounds__(THREADS, 3) attend_kernel",
                      f"__launch_bounds__(THREADS, {mb}) attend_kernel")):
        if old not in t:
            raise RuntimeError(f"decode_tile.cuh no longer has {old!r}")
        t = t.replace(old, new)
    (work / "decode_tile.cuh").write_text(t)
    so = work / "probe.so"
    r = subprocess.run([build.nvcc_path(), *build.FLAGS, "-o", str(so),
                        str(work / "int8_kv_decode_attention.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = [ln.split(":", 1)[1].strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln]
    return name, ctypes.CDLL(str(so)), regs


def decode() -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import int8_kv_decode_attention as dk
    from repro_torch.models.attention import _quant_kv
    with ThreadPoolExecutor(len(DECODE_VARIANTS)) as ex:
        libs = list(ex.map(lambda kv: build_variant(*kv), DECODE_VARIANTS.items()))
    current = {}

    def entry(name, symbol, argtypes):
        fn = getattr(current["lib"], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn
    build.entry = entry
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn, timer = cs.randn_on(dev, gen), cs.Timer(dev)
    cases = []
    for hq, hkv in ((32, 32), (24, 2)):
        b, s, d = 8, 1024, 128
        k_q, k_s = _quant_kv(randn(b, s, hkv, d))
        v_q, v_s = _quant_kv(randn(b, s, hkv, d))
        fill = torch.randint(256, s + 1, (b,), generator=gen, device=dev)
        fill[3] = 0
        slot = torch.arange(s, device=dev)
        pos = torch.where(slot[None] < fill[:, None], slot[None], -1).to(torch.int32)
        last = (fill - 1).to(torch.int32)
        for t in (1, 256):
            qp = last[:, None] - torch.arange(t - 1, -1, -1, device=dev,
                                              dtype=torch.int32)[None]
            qp = torch.where((last[:, None] >= 0) & (qp >= 0), qp, -1).to(
                torch.int32).contiguous()
            cases.append((f"G={hq // hkv} T={t}", (randn(b, t, hq, d).to(
                torch.bfloat16), k_q, k_s, v_q, v_s, pos, qp)))
    ref = {}
    for name, lib, regs in libs:
        current["lib"] = lib
        build._ENTRIES.clear()
        _, nr, stages, _, _ = DECODE_VARIANTS[name]
        dk.NR, dk.STAGES = nr, stages
        line = []
        for label, args in cases:
            def run():
                return dk.int8_kv_decode_attention_rows(*args)
            out = run()
            if label in ref and not torch.equal(out, ref[label]):
                raise AssertionError(f"{name} {label}: differs from the committed body")
            ref.setdefault(label, out)
            line.append(f"{label} {timer(run):.5f} ms")
        print(f"{name:10s} " + " | ".join(line) + f" [{'; '.join(regs)}]", flush=True)


# (source, variant, [(text, replacement), ...]): the work each variant drops
ABLATIONS = (
    ("int8_flash_attention", "full", []),
    ("int8_flash_attention", "no PV FMAs", [
        ("        while (todo != 0u) {", "        todo = 0u; while (todo != 0u) {")]),
    ("int8_flash_attention", "every key (no mask)", [
        ("        while (todo != 0u) {", "        todo = ~0u; while (todo != 0u) {")]),
    ("int8_flash_attention", "no V dequant", [
        ("if constexpr (VS) {                  // the V tile", "if (kt < 0) {  //")]),
    ("int8_flash_attention", "no integer exp", [
        ("  const int qs = max(s - m, NEG_INF);\n  const int z",
         "  return (s - m) & 127;\n  const int qs = max(s - m, NEG_INF);\n  const int z")]),
    ("ssd_scan", "full", []),
    ("ssd_scan", "no W exp", [
        ("expf(static_cast<float>(ck[i] - cj)) * dj;", "dj;")]),
    ("ssd_scan", "no y products", [
        ("    for (int j = 0; j < j1; ++j)\n", "    for (int j = 0; j < 0; ++j)\n"),
        ("    for (int j = j1; j < j2; ++j) {", "    for (int j = j1; j < j1; ++j) {"),
        ("      for (int n = 0; n < N; ++n)\n        fma8", "      for (int n = 0; n < 0; ++n)\n        fma8")]),
    ("int_softmax", "full", []),
    ("int_softmax", "no exp", [
        ("      v[k] = int_exp(v[k], mx, p);", "      v[k] = (v[k] - mx) & 1023;")]),
    ("int_softmax", "no probability", [
        ("  return min(div_rcp(static_cast<unsigned>(max(num, 0)), lm, lsh), 127);",
         "  return num & 127;")]),
    ("int_softmax", "no exp, no probability", [
        ("      v[k] = int_exp(v[k], mx, p);", "      v[k] = (v[k] - mx) & 1023;"),
        ("  return min(div_rcp(static_cast<unsigned>(max(num, 0)), lm, lsh), 127);",
         "  return num & 127;")]),
    ("int_softmax", "no store", [
        ("      *reinterpret_cast<uint4*>(orow + e0) = make_uint4(",
         "      if (w[0] == 0x12345678u) *reinterpret_cast<uint4*>(orow + e0) = make_uint4(")]),
    ("int8_conv2d", "full", []),
    ("int8_conv2d", "no epilogue", [
        ("        if (m >= p.M) continue;", "        if (m >= 0) continue;")]),
    ("int8_conv2d", "no main loop", [
        ("  mma_gemm::mainloop<C, W8, 1>(p.x,", "  if (p.K < 0) mma_gemm::mainloop<C, W8, 1>(p.x,")]),
)


def build_ablation(source, name, edits):
    from repro_torch.kernels import build
    work = ROOT / "build/probe_ablate" / f"{source}-{name.replace(' ', '_')}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src/repro_torch/kernels/csrc", work)
    t = (work / f"{source}.cu").read_text()
    for old, new in edits:
        if old not in t:
            raise RuntimeError(f"{source}.cu no longer has {old!r}")
        t = t.replace(old, new)
    (work / f"{source}.cu").write_text(t)
    so = work / "probe.so"
    r = subprocess.run([build.nvcc_path(), *build.FLAGS, "-o", str(so),
                        str(work / f"{source}.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{source} {name}: nvcc failed\n{r.stdout}{r.stderr}")
    return source, name, ctypes.CDLL(str(so))


def ablate() -> None:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build, ops
    from repro_torch.models.attention import int_score_scale
    with ThreadPoolExecutor(len(ABLATIONS)) as ex:
        libs = list(ex.map(lambda a: build_ablation(*a), ABLATIONS))
    committed, current = build.entry, {}

    def entry(name, symbol, argtypes):
        if name != current["source"]:            # the inputs' own kernels
            return committed(name, symbol, argtypes)
        fn = getattr(current["lib"], symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn
    build.entry = entry
    current["source"] = None
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = cs.randn_on(dev, gen)
    q, k, v, v_s = cs.int_attention_inputs(randn, 32, 32)
    sc = int_score_scale(128)
    x = randn(cs.Z_B, cs.Z_T, cs.Z_H, cs.Z_P)
    dt = torch.nn.functional.softplus(randn(cs.Z_B, cs.Z_T, cs.Z_H) - 1.0)
    a = -torch.linspace(1.0, 16.0, cs.Z_H, device=dev)
    bm, cm = randn(cs.Z_B, cs.Z_T, cs.Z_N), randn(cs.Z_B, cs.Z_T, cs.Z_N)
    xs = torch.randint(-3000, 3000, (4, 1024, 1024), generator=gen, device=dev,
                       dtype=torch.int32)
    keep = torch.ones((1024, 1024), dtype=torch.bool, device=dev).tril()

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    pe = (i8(cs.VIT_IMAGES, 14, 14, 768), i8(1, 1, 768, cs.VIT_D),
          torch.zeros(cs.VIT_D, dtype=torch.int32, device=dev))
    c3 = (i8(8, 56, 56, 64), i8(3, 3, 64, 64), torch.zeros(64, dtype=torch.int32, device=dev))
    calls = {"int8_flash_attention": (
                ("v_scale", lambda: ops.attention_i8(q, k, v, sc, v_scale=v_s)),
                ("int32", lambda: ops.attention_i8(q, k, v, sc))),
             "ssd_scan": (("N=64", lambda: ops.ssd_scan(x, dt, a, bm, cm)),),
             "int_softmax": (("[4096,1024] int32", lambda: ops.softmax_i8(xs, sc)),
                             ("causal mask", lambda: ops.softmax_i8(xs, sc, keep))),
             "int8_conv2d": (("patch embed", lambda: ops.conv2d_i8(*pe)),
                             ("3x3", lambda: ops.conv2d_i8(*c3)))}
    ref = {}
    for source, name, lib in libs:
        current.update(lib=lib, source=source)
        build._ENTRIES.clear()
        line = []
        for label, fn in calls[source]:
            out = fn()
            if name == "full":
                ref[label] = out
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            ms = {e.key.split("<")[0].split("::")[-1].split("(")[0]:
                  (getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0)) / 1e4
                  for e in prof.key_averages()
                  if e.key.split("<")[0].split("::")[-1].startswith(
                      ("int8_attention", "ssd_scan", "int_softmax", "int8_conv2d"))}
            line.append(f"{label} {sum(ms.values()):.4f} ms ("
                        + ", ".join(f"{kn} {t:.4f}" for kn, t in ms.items()) + ")")
        print(f"{source} {name:20s} " + " | ".join(line), flush=True)
    # the committed build's output against the unedited copy's
    build._ENTRIES.clear()
    build.entry = committed
    for label, fn in (fn for source_calls in calls.values() for fn in source_calls):
        got = fn()
        got, want = (got[0], ref[label][0]) if isinstance(got, tuple) else (got, ref[label])
        if not torch.equal(got, want):
            raise AssertionError(f"ablate: the unedited copy's {label} output differs")


def conv() -> None:
    import chip_smoke as cs
    from repro_torch.kernels import conv2d, ops
    from repro_torch.kernels import int_softmax as sm
    from repro_torch.models.attention import int_score_scale
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = cs.Timer(dev)
    committed_tiling, committed_form = conv2d.tiling, sm.form
    forced = {}
    conv2d.tiling = lambda m, o: forced["tile"]
    sm.form = lambda n: forced["form"]

    def ints(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=dtype)
    for n_, h, wd, c, kh, kw, o in (cs.TABLE2_CONV, (8, 56, 56, 64, 3, 3, 64),
                                    cs.FIRST_LAYER_CONV,
                                    (cs.VIT_IMAGES, 14, 14, 768, 1, 1, cs.VIT_D)):
        x, w = ints(-128, 128, n_, h, wd, c), ints(-128, 128, kh, kw, c, o)
        b = ints(-2 ** 20, 2 ** 20, o, dtype=torch.int32)
        m = n_ * (h - kh + 1) * (wd - kw + 1)
        line, ref = [], None
        for tile in conv2d.CONFIGS:
            forced["tile"] = tile
            out = ops.conv2d_i8(x, w, b)
            if ref is not None and not torch.equal(out, ref):
                raise AssertionError(f"conv {tile}: differs from {next(iter(conv2d.CONFIGS))}")
            ref = out if ref is None else ref
            ms = timer(lambda: ops.conv2d_i8(x, w, b))
            line.append(f"{tile[0]}x{tile[1]} {ms:.5f}")
        print(f"conv [{n_},{h},{wd},{c}]x[{kh},{kw},{c},{o}] (rule "
              f"{committed_tiling(m, o)}): " + " | ".join(line), flush=True)
        del x, w, b, out, ref
    # the timer's floor: two events alone, and a kernel that does nothing
    print(f"timer floor: events {timer(lambda: None):.5f} | empty kernel "
          f"{timer(lambda: torch.cuda._sleep(0)):.5f}", flush=True)
    # the committed rules with L2 flushed by a read (clean lines) instead of
    # chip_smoke.Timer's write, whose dirty lines the kernel must evict
    conv2d.tiling, sm.form = committed_tiling, committed_form
    clean = cs.Timer(dev)
    src = clean.flush
    clean.flush = types.SimpleNamespace(zero_=lambda: src.max())
    clean.flush.zero_()
    torch.cuda.synchronize()
    for n_, h, wd, c, kh, kw, o in ((8, 56, 56, 64, 3, 3, 64), cs.FIRST_LAYER_CONV,
                                    (cs.VIT_IMAGES, 14, 14, 768, 1, 1, cs.VIT_D)):
        x, w = ints(-128, 128, n_, h, wd, c), ints(-128, 128, kh, kw, c, o)
        b = ints(-2 ** 20, 2 ** 20, o, dtype=torch.int32)
        print(f"conv [{n_},{h},{wd},{c}]x[{kh},{kw},{c},{o}] rule: written flush "
              f"{timer(lambda: ops.conv2d_i8(x, w, b)):.5f} | read flush "
              f"{clean(lambda: ops.conv2d_i8(x, w, b)):.5f}", flush=True)
    sc = int_score_scale(128)
    xs = torch.randint(-3000, 3000, (4096, 1024), generator=gen, device=dev,
                       dtype=torch.int32)
    x8 = xs.clamp(-128, 127).to(torch.int8)
    keep = torch.ones((1024, 1024), dtype=torch.bool, device=dev).tril()
    for name, xx, mask in (("int32", xs, None), ("int32 broadcast mask", xs.view(4, 1024, 1024), keep),
                           ("int8", x8, None)):
        print(f"softmax [4096,1024] {name} rule: written flush "
              f"{timer(lambda: ops.softmax_i8(xx, sc, mask)):.5f} | read flush "
              f"{clean(lambda: ops.softmax_i8(xx, sc, mask)):.5f}", flush=True)
    print(f"empty kernel, read flush {clean(lambda: torch.cuda._sleep(0)):.5f}", flush=True)
    conv2d.tiling = lambda m, o: forced["tile"]
    sm.form = lambda n: forced["form"]
    sc = int_score_scale(128)
    x = torch.randint(-3000, 3000, (4096, 1024), generator=gen, device=dev,
                      dtype=torch.int32)
    keep = torch.ones((1024, 1024), dtype=torch.bool, device=dev).tril()
    for name, mask in (("int32", None), ("int32 broadcast mask", keep)):
        xs = x if mask is None else x.view(4, 1024, 1024)
        line, ref = [], None
        for f in (1, 2, 4, 8):
            forced["form"] = f
            out = ops.softmax_i8(xs, sc, mask)
            if ref is not None and not torch.equal(out, ref):
                raise AssertionError(f"softmax form {f}: differs from form 1")
            ref = out if ref is None else ref
            ms = timer(lambda: ops.softmax_i8(xs, sc, mask))
            line.append(f"form {f} {ms:.5f}")
        print(f"softmax [4096,1024] {name} (rule {committed_form(1024)}): "
              + " | ".join(line), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("tiles", "decode", "ablate", "conv"):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("chip_probe: no CUDA device")
    {"tiles": tiles, "decode": decode, "ablate": ablate, "conv": conv}[sys.argv[1]]()
