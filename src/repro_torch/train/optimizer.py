"""AdamW with global-norm clipping (port of ``repro.train.optimizer``).

Master params f32; moments f32; decoupled weight decay on the leaves of
rank >= 2; each parameter keeps its dtype.  The rank is the leaf's in the
reference's tree, where a layer's leaves are stacked over the periods: so a
layer's norm scales and biases are decayed there and the final norm is not
(ROADMAP.md C19).  ``adamw_update`` takes those ranks (``ndims``, from
``convert.reference_ndims``; default each tensor's own).  The parameters,
gradients and moments are name -> tensor mappings
(``dict(module.named_parameters())``, which lists a parameter held at
several positions once: zamba2's shared block is one leaf, updated once, as
the reference updates ``params["shared"]`` once).  Unlike the reference,
which returns new trees, ``adamw_update`` writes the parameters and moments
IN PLACE, one tensor at a time and in slices of ``CHUNK`` values, so that
its temporaries stay small beside a full-width model (the embedding alone
is 151 M f32 values).

The reference's step is one ``jax.jit`` program; the port keeps the
rounding XLA:CPU gives it, so that the update is bit-exact against the
reference given the same gradients (``tests/test_torch_train.py``):

* C1: a division by a Python-float constant is a product with its f32
  reciprocal (the schedule's ``/ max(warmup, 1)``); a traced divisor a true
  division;
* C2: XLA contracts ``a*b + c`` into one FMA (``fma_f32``): the moment
  updates, the schedule's ``min_lr_ratio + (1 - min_lr_ratio) * cos``, the
  decay ``delta + wd*p`` and the step ``p - lr*delta``;
* XLA's simplifier turns ``(m / b1c) / den`` into ``m / (b1c * den)``;
* ``sqrt``, ``cos`` and ``pow`` are correctly rounded (computed in f64 and
  rounded once: torch's vectorised f32 ``sqrt`` on the CPU is not).

The global norm sums each gradient's squares in f64 and rounds once; XLA
sums them in f32 in its own order, so the two agree to about 1e-7 relative,
and below ``grad_clip`` the norm does not enter the update at all.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..kernels.common import f32, fma_f32, rcp32

F32 = torch.float32
CHUNK = 1 << 24          # values a slice of the update works on at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                  # 0-dim int32
    mu: dict[str, torch.Tensor]         # f32, one per parameter
    nu: dict[str, torch.Tensor]


def init_opt_state(params: dict[str, torch.Tensor]) -> OptState:
    """Zero f32 moments shaped like ``params``, step 0 on their device."""
    dev = next(iter(params.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()})


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (0-dim f32)."""
    dev = step.device
    s = step.to(F32)
    warm = torch.clamp(s * f32(rcp32(max(cfg.warmup_steps, 1)), dev), max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps).to(F32)
                       * f32(rcp32(span), dev), 0.0, 1.0)
    cos = torch.cos((f32(math.pi, dev) * prog).double()).to(F32)
    cos = f32(0.5, dev) * (f32(1.0, dev) + cos)
    return (f32(cfg.lr, dev) * warm) * fma_f32(
        f32(1 - cfg.min_lr_ratio, dev), cos, f32(cfg.min_lr_ratio, dev))


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares (0-dim f32)."""
    sq = [torch.sum(torch.square(x.double())).to(F32)
          for x in tensors.values()]
    return torch.sqrt(torch.sum(torch.stack(sq).double())).to(F32)


def _chunks(n: int):
    return (slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK))


def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: OptState,
                 ndims: dict[str, int] | None = None):
    """One AdamW step, in place: returns (params, new_state, metrics) with
    ``metrics`` {"grad_norm", "lr"} as 0-dim f32 tensors.  ``ndims``: the
    rank that decides each parameter's decay (default its own)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp(f32(cfg.grad_clip, dev)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.double()
    b1c = f32(1.0, dev) - torch.pow(f32(cfg.b1, dev).double(), sf).to(F32)
    b2c = f32(1.0, dev) - torch.pow(f32(cfg.b2, dev).double(), sf).to(F32)
    b1, b2 = f32(cfg.b1, dev), f32(cfg.b2, dev)
    c1, c2 = f32(1 - cfg.b1, dev), f32(1 - cfg.b2, dev)
    eps, wd, neg_lr = f32(cfg.eps, dev), f32(cfg.weight_decay, dev), -lr
    with torch.no_grad():
        for name, p in params.items():
            flat_p = p.view(-1)
            flat_g = grads[name].reshape(-1)
            flat_m, flat_v = state.mu[name].view(-1), state.nu[name].view(-1)
            for sl in _chunks(flat_p.numel()):
                g = flat_g[sl].to(F32) * scale
                m = fma_f32(b1, flat_m[sl], c1 * g)
                v = fma_f32(b2, flat_v[sl], (c2 * g) * g)
                den = torch.sqrt((v / b2c).double()).to(F32) + eps
                delta = m / (b1c * den)
                pf = flat_p[sl].to(F32)
                if (p.dim() if ndims is None else ndims[name]) >= 2:
                    delta = fma_f32(wd, pf, delta)
                flat_p[sl] = fma_f32(neg_lr, delta, pf).to(p.dtype)
                flat_m[sl] = m
                flat_v[sl] = v
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                        "lr": lr}
