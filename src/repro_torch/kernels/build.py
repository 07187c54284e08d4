"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``, pointers as
``void*``, the stream as ``void*``, an ``int`` return that is the launch's
``cudaGetLastError()``) and compiles on its own into
``build/kernels/<name>-<hash>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: the kernels are held bit-exact against their plain
versions.  ``<hash>`` covers every source under ``csrc/`` and the flags, so an
edited source rebuilds and an unchanged one is reused.  The build runs at
first use (``load``), all sources at once in parallel.  ``build/`` is listed
in ``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` moves it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("quantize", "int8_gemm", "int_layernorm", "int8_kv_decode_attention",
           "int4_gemm", "dual_gemm_gated", "dual_int4_gemm_gated",
           "paged_decode_attention", "int_softmax", "int8_flash_attention",
           "flash_attention", "int_gelu", "int_silu", "requantize",
           "int8_conv2d", "ssd_scan", "bf16_gemm")
CSRC = Path(__file__).resolve().with_name("csrc")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

VP = ctypes.c_void_p  # every pointer and the stream
I = ctypes.c_int
U = ctypes.c_uint
F = ctypes.c_float

_LIBS: dict[str, ctypes.CDLL] = {}
# per source: {"path", "seconds", "ptxas"} of the build this process ran
BUILD_LOG: dict[str, dict] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are compiled on the machine with the card")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest()}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together.  Returns ``BUILD_LOG`` (each source's
    seconds from the common start to its own end); raises with the
    compiler's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    pending = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            pending[name] = (subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT),
                             tmp, log, dst)
    failed = []
    while pending:
        for name, (proc, tmp, log, dst) in list(pending.items()):
            if proc.poll() is None:
                continue
            del pending[name]
            secs = time.perf_counter() - t0
            text = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) "
                              f"---\n{text}")
                continue
            os.replace(tmp, dst)
            BUILD_LOG[name] = {"path": str(dst), "seconds": secs,
                               "ptxas": text}
        time.sleep(0.05)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all sources in
    parallel at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


_ENTRIES: dict[str, ctypes._CFuncPtr] = {}


def entry(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared once (pointers and the stream as ``c_void_p``: a bare Python
    int would be passed as a 32-bit int and cut)."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


def check_rc(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
