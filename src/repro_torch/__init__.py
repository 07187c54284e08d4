"""PyTorch + CUDA port of the ``repro`` package (NX-CGRA reproduction).

The JAX package ``src/repro/`` stays the reference; this package mirrors its
layout file for file and serves the same models on an NVIDIA H100.  It
imports ``torch``, numpy and the stdlib only — never ``jax`` and never
anything of ``repro``.

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel for
``sm_90a`` (``kernels/csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes``.  Kernel dispatch goes by the tensor's device: a CPU tensor
takes the kernel's plain PyTorch version, a CUDA tensor launches the kernel
(or raises).  Entry points (``init_params``, ``ServingEngine``,
``launch/serve.py``) run on the card unless the caller passes
``device="cpu"``.
"""
