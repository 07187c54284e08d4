"""Device meshes: the production and elastic mesh shapes, the serving
tensor-parallel group (``make_tp_mesh``) and the typed error.

Port of ``repro.launch.mesh``.  ``make_production_mesh`` (16 x 16 = 256
cards a pod; 2 pods = 512) and ``make_elastic_mesh`` give a ``MeshShape``:
the named axis sizes of a ``torch.distributed`` device mesh (what
``torch.distributed.device_mesh.init_device_mesh("cuda", sizes,
mesh_dim_names=axes)`` takes in a process group of that many ranks, one
card a rank).  Like the reference's ``_validate_axes`` they raise
``MeshDeviceError`` where the cards fall short — on one H100 always — unless
the caller names the device count (``launch/dryrun.py``'s 512
placeholders, as the reference's dry run forces 512 host devices).
``mesh_axis_size`` reads an axis, 1 where the mesh has none.

The reference's ``make_tp_mesh`` builds a one-axis ("tp",)
``jax.sharding.Mesh`` over the first tp devices; the port runs one process
per rank, and each calls ``make_tp_mesh`` with its rank to join a
``torch.distributed`` group of tp ranks.  The caller names the backend; none is chosen for it, and nothing
switches between them:

* ``"nccl"``: rank r on ``cuda:r`` (one card a rank, collectives on the
  card).  Fewer than tp cards raise ``MeshDeviceError``.
* ``"gloo"``: every rank on ``device``, which all ranks share — by
  default the current card, as for every entry point of the port, or
  ``"cpu"``.  NCCL refuses two ranks on one card, so there the
  collectives stage through host buffers (``dist.tp._collective``).

Nothing tells a process of the others: the group meets at
``tcp://localhost:<port>``, a port the caller gives every rank.
``run_ranks`` spawns the ranks of one group and collects their results.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import socket
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..kernels.common import resolve_device

# a collective that waits longer than this has lost a rank
_TIMEOUT = datetime.timedelta(seconds=600)


class MeshDeviceError(ValueError):
    """Requested mesh axis sizes exceed (or do not tile) the device count."""


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh's named axes and their sizes, outermost first."""

    axes: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _make_mesh(sizes, axes, n_devices: int | None) -> MeshShape:
    need = math.prod(sizes)
    have = _cards() if n_devices is None else n_devices
    if need > have:
        raise MeshDeviceError(
            f"mesh {dict(zip(axes, sizes))} needs {need} cards but only "
            f"{have} are available; a plan without cards names the count "
            f"(n_devices={need}, as launch/dryrun.py does)")
    return MeshShape(tuple(axes), tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False,
                         n_devices: int | None = None) -> MeshShape:
    """16x16 = 256 cards a pod; 2 pods = 512 with multi_pod=True, over the
    cards present (or ``n_devices`` placeholders)."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(sizes, axes, n_devices)


def make_elastic_mesh(n_devices: int, model_parallel: int = 16) -> MeshShape:
    """Re-mesh after node loss: whatever devices remain, same model axis
    (the elastic restore of a 512-card checkpoint onto 256)."""
    if n_devices % model_parallel:
        raise MeshDeviceError(
            f"elastic mesh: n_devices={n_devices} is not a multiple of "
            f"model_parallel={model_parallel}")
    return _make_mesh((n_devices // model_parallel, model_parallel),
                      ("data", "model"), None)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """One rank's view of its TP group: the process group, its size, this
    process's rank, the backend and the device this rank runs on."""

    group: Any
    size: int
    rank: int
    backend: str
    device: torch.device

    @property
    def devices(self) -> list[str]:
        """Every rank's device, by rank."""
        if self.backend == "nccl":
            return [f"cuda:{r}" for r in range(self.size)]
        return [str(self.device)] * self.size


def free_port() -> int:
    """A free TCP port on localhost for the group to meet at (chosen by the
    parent, handed to every rank)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_tp_mesh(tp: int, backend: str, *, rank: int, port: int,
                 device=None) -> TPMesh:
    """Join rank ``rank`` of a group of ``tp`` ranks over ``backend``
    ("gloo" or "nccl") meeting at localhost:``port``.  ``device``: gloo's
    device for every rank (default the current card; ``"cpu"`` for the
    CPU); nccl puts rank r on cuda:r and takes no device."""
    if tp < 1:
        raise MeshDeviceError(f"tp must be >= 1, got {tp}")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tp:
            raise MeshDeviceError(
                f"a tp={tp} NCCL group puts one rank on each card and needs "
                f"{tp} cards, but {have} are available; several ranks on "
                f"one card take backend='gloo' with that card as device")
        if device is not None:
            raise ValueError("backend='nccl' puts rank r on cuda:r: pass no "
                             "device")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    elif backend == "gloo":
        dev = resolve_device(device)
    else:
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if not 0 <= rank < tp:
        raise MeshDeviceError(f"rank {rank} is outside a group of {tp}")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=tp, rank=rank, timeout=_TIMEOUT)
    return TPMesh(dist.group.WORLD, tp, rank, backend, dev)


def _rank_main(rank: int, fn, port: int, results, args) -> None:
    try:
        res = fn(rank, port, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, res))


def run_ranks(fn, tp: int, *args) -> list:
    """Run ``fn(rank, port, *args)`` in ``tp`` spawned processes (a fresh
    interpreter each: ``fn`` and ``args`` travel pickled) and return their
    results by rank.  ``port`` is where the group meets
    (``make_tp_mesh``).  A rank that raises ends the others and re-raises
    here with its traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(_rank_main, args=(fn, free_port(), results,
                                                 args),
                               nprocs=tp, join=False, start_method="spawn")
    got = {}
    done = False
    while not done:
        done = procs.join(timeout=0.5)
        # read as the ranks write: a rank's put waits for a full pipe
        while not results.empty():
            rank, res = results.get()
            got[rank] = res
    return [got[r] for r in range(tp)]
