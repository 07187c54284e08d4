"""Trainer: the train step (loss -> grads -> AdamW), gradient accumulation,
watchdog, checkpointing (port of ``repro.train.trainer``).

The reference's step is one jitted program; the port's runs eagerly where
the parameters live: ``torch.autograd.grad`` of ``lm_loss`` (each layer
recomputed in the backward under ``cfg.remat``), then the in-place AdamW
of ``train.optimizer``.  Gradient accumulation runs the microbatches in a
loop, in the order of the reference's ``lax.scan``: each microbatch's
gradient divided by ``accum_steps`` (a product with its f32 reciprocal, as
jitted) and added into f32 zeros, the loss likewise.  Optional int8
gradient compression (error feedback) goes through ``dist.compression``.

Training is the bf16 path: a config whose ``precision`` is an integer one
raises ``NotImplementedError`` — the reference's integer paths define
gradients only through rounding (``round`` has a zero derivative), so there
is nothing meaningful to port; ``"bf16"`` is every config's default and what
the reference's own tests train.  On the card the bf16 forward launches
flash_attention, ssd_scan and the bf16 dual_gemm_gated (unbatched and
expert-batched), each inside a ``torch.autograd.Function`` whose backward
is autograd of its plain version (``kernels.common.GRAD_KERNELS``); every
other kernel refuses an input that requires grad
(``kernels.common.on_cuda``).  So every arch the port serves trains on
the card at bf16: the dense, GQA, zamba2, MoE, xLSTM (no kernel) and
cross-attention decoders through ``lm_loss``, whisper through
``models.encdec_loss`` (the reference's trainer has no encoder-decoder
batch, so the ``Trainer`` takes ``lm_loss`` only, as the reference's).

The reference's ``make_loss_fn`` adds no MoE aux loss (its branch is
``pass``), and neither does the port's (``models.moe.moe_aux_loss`` exists,
unwired, as in the reference).

Straggler mitigation at framework level: a step-time watchdog flags steps
exceeding ``watchdog_factor`` x the trailing median; here it logs and
counts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..convert import reference_ndims
from ..dist.compression import compress_grads, decompress_grads, init_error_state
from ..kernels.common import f32, fma_f32, rcp32, resolve_device
from ..models import ArchConfig, lm_loss
from ..models.lm import LM
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1          # microbatch accumulation factor
    aux_loss_weight: float = 0.01  # MoE load-balance loss (unused, as in
    #                                the reference's loss_fn)
    grad_compression: bool = False
    watchdog_factor: float = 3.0
    log_every: int = 10
    checkpoint_every: int = 200


def make_loss_fn(cfg: ArchConfig, train_cfg: TrainConfig) -> Callable:
    """loss_fn(params, batch) -> the 0-dim f32 ``lm_loss`` of the batch."""
    def loss_fn(params: LM, batch: dict):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       kv_source=batch.get("kv_source"))
    return loss_fn


def trained_params(params: LM) -> dict[str, torch.Tensor]:
    """The parameters a step trains, by ``named_parameters`` name (a
    parameter held at several positions listed once): those that require
    grad."""
    return {k: p for k, p in params.named_parameters() if p.requires_grad}


def value_and_grad(loss_fn: Callable, params: LM, named: dict, batch: dict):
    """(loss, {name: gradient}) of ``loss_fn(params, batch)`` against the
    tensors of ``named``; a parameter the loss does not reach gets zeros,
    as in the reference's gradient tree."""
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(named.items(), grads)}


def make_train_step(cfg: ArchConfig, train_cfg: TrainConfig):
    """Returns train_step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics): ``params`` (an ``LM``) is
    updated in place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr``
    as 0-dim f32 tensors."""
    loss_fn = make_loss_fn(cfg, train_cfg)
    n = train_cfg.accum_steps

    def train_step(params: LM, opt_state: OptState, err_state, batch: dict):
        named = trained_params(params)
        if n > 1:
            dev = params.device
            inv = f32(rcp32(n), dev)
            grads = {k: torch.zeros(p.shape, dtype=F32, device=dev)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=F32, device=dev)
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                  for k, v in batch.items()}
            for i in range(n):
                l, g = value_and_grad(loss_fn, params, named,
                                      {k: v[i] for k, v in mb.items()})
                for k in grads:               # acc + g / n, one rounding
                    grads[k] = fma_f32(g[k].to(F32), inv, grads[k])
                del g
                loss = fma_f32(l, inv, loss)
        else:
            loss, grads = value_and_grad(loss_fn, params, named, batch)

        if train_cfg.grad_compression:
            payload, err_state = compress_grads(grads, err_state)
            grads = decompress_grads(payload)  # wire payload is the int8 set

        _, opt_state, metrics = adamw_update(
            train_cfg.optimizer, named, grads, opt_state,
            reference_ndims(params, cfg))
        metrics = dict(metrics, loss=loss)
        return params, opt_state, err_state, metrics

    return train_step


class Watchdog:
    """Trailing-median step-time monitor (straggler detection)."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.factor * med
            if slow:
                self.flagged += 1
        self.times.append(dt)
        self.times = self.times[-self.window:]
        return slow


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) on ``device``: integer arrays (tokens,
    labels) as int64, float ones as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, None if t.is_floating_point() else torch.long)
    return out


class Trainer:
    """Host-side loop: data, the step, watchdog, checkpoint cadence.

    ``params`` is an ``LM`` on ``device`` (the card unless the caller
    passes device='cpu'; raises if the parameters live elsewhere).  Every
    float parameter is set to require grad and trained."""

    def __init__(self, cfg: ArchConfig, train_cfg: TrainConfig, params: LM,
                 ckpt_manager=None, device=None):
        if cfg.precision != "bf16":
            raise NotImplementedError(
                f"training at precision {cfg.precision!r}: the reference's "
                f"integer paths define gradients only through rounding; the "
                f"port trains the bf16 path (ROADMAP.md item 9)")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"the parameters live on {params.device}, the "
                             f"trainer runs on {self.device}")
        for p in params.parameters():
            if p.is_floating_point():
                p.requires_grad_(True)
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.params = params
        self.named = trained_params(params)
        self.opt_state = init_opt_state(self.named)
        self.err_state = (init_error_state(self.named)
                          if train_cfg.grad_compression else None)
        self.step_fn = make_train_step(cfg, train_cfg)
        self.watchdog = Watchdog(train_cfg.watchdog_factor)
        self.ckpt = ckpt_manager
        self.step = 0
        self.history: list[dict[str, float]] = []

    def restore(self, step: int) -> dict:
        """Load the manager's checkpoint ``step`` into the parameters (in
        place) and the optimizer state; returns its metadata."""
        named, opt, meta = self.ckpt.restore(step, self.named, self.opt_state,
                                             device=self.device)
        with torch.no_grad():
            for k, p in self.named.items():
                p.copy_(named[k])
        self.opt_state = opt
        return meta

    def run(self, data_iter, n_steps: int, log_fn=print) -> list[dict]:
        for _ in range(n_steps):
            batch = to_device(next(data_iter), self.device)
            t0 = time.time()
            self.params, self.opt_state, self.err_state, metrics = self.step_fn(
                self.params, self.opt_state, self.err_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            slow = self.watchdog.observe(dt)
            metrics.update(step=self.step, dt=dt, straggler=slow)
            self.history.append(metrics)
            if self.step % self.train_cfg.log_every == 0:
                log_fn(f"step {self.step:5d} loss {metrics['loss']:.4f} "
                       f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f} ms"
                       + (" [STRAGGLER]" if slow else ""))
            if (self.ckpt is not None and self.step > 0
                    and self.step % self.train_cfg.checkpoint_every == 0):
                self.ckpt.save(self.step, self.named, self.opt_state,
                               meta={"arch": self.cfg.name})
            self.step += 1
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.named, self.opt_state,
                           meta={"arch": self.cfg.name}, blocking=True)
        return self.history
