"""Checkpointing: npz per step, async save, atomic rename, restore onto any
device (port of ``repro.train.checkpoint``).

Fault-tolerance contract, the reference's:

  * **Atomicity** — write to ``step_N.tmp/`` then ``os.replace`` to
    ``step_N/``; a crash mid-save never corrupts the latest checkpoint.
  * **Async** — serialization runs on a background thread; training blocks
    only on the device->host copy of the save.
  * **Keep-K** — bounded disk usage; the newest K checkpoints survive.
  * **Device-agnostic (elastic)** — arrays are saved whole by name, so a
    checkpoint written on the card restores onto the CPU or the card
    (``restore``'s ``device``): the port's form of the reference's re-shard
    against whatever mesh is active.
  * **Self-describing** — metadata.json records the step and the arch, so
    the launcher resumes the data pipeline restart-exactly.

Names are the port's ``named_parameters`` names; the optimizer's moments
are saved under the same names behind ``mu/`` and ``nu/``, and its step as
``step``.  bf16 tensors are stored as f32 (numpy has no bf16) and cast back
to the template's dtype on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..kernels.common import resolve_device
from .optimizer import OptState


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flat_params(named: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: _host(t) for k, t in named.items()}


def _flat_opt(state: OptState) -> dict[str, np.ndarray]:
    out = {"step": _host(state.step)}
    for part in ("mu", "nu"):
        out.update({f"{part}/{k}": _host(t)
                    for k, t in getattr(state, part).items()})
    return out


def _like(flat: dict, key: str, tmpl: torch.Tensor, device) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint missing array: {key}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(tmpl.shape)}")
    return torch.from_numpy(np.array(arr)).to(device, tmpl.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params: dict[str, torch.Tensor],
             opt_state: OptState | None = None, meta: dict | None = None,
             blocking: bool = False) -> None:
        """Save ``params`` (name -> tensor) and ``opt_state`` as step
        ``step``; the write runs on a background thread after the copy to
        the host (``blocking``: wait for it)."""
        self.wait()  # one in-flight save at a time
        # device->host transfer happens here (the only sync point)
        host_params = _flat_params(params)
        host_opt = _flat_opt(opt_state) if opt_state is not None else None
        meta = dict(meta or {}, step=step, time=time.time())

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "params.npz"), **host_params)
            if host_opt is not None:
                np.savez(os.path.join(tmp, "opt_state.npz"), **host_opt)
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, params_template: dict[str, torch.Tensor],
                opt_template: OptState | None = None, device=None):
        """(params, opt_state, meta) of checkpoint ``step``: every name of
        the templates present with the template's shape (else KeyError /
        ValueError), in the template's dtype, on ``device`` (the card unless
        the caller passes device='cpu')."""
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "params.npz")) as z:
            flat = dict(z)
        params = {k: _like(flat, k, t, dev) for k, t in params_template.items()}
        opt_state = None
        if opt_template is not None:
            with np.load(os.path.join(path, "opt_state.npz")) as z:
                flat = dict(z)
            opt_state = OptState(
                step=_like(flat, "step", opt_template.step, dev),
                mu={k: _like(flat, f"mu/{k}", t, dev)
                    for k, t in opt_template.mu.items()},
                nu={k: _like(flat, f"nu/{k}", t, dev)
                    for k, t in opt_template.nu.items()})
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        return params, opt_state, meta
