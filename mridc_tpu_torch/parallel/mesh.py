"""Data parallelism across processes (counterpart of
``mridc_tpu/parallel/mesh.py``), on ``torch.distributed``.

On the JAX side a ``Mesh`` with a ``data`` axis shards one global batch over
the devices and XLA computes one function of the whole batch, inserting the
gradient's reduction. Here one process drives one card, and a :class:`Mesh`
describes the default process group's ``data`` axis: its size (the world
size), this process's rank and device, and the axis names. Without a process
group the mesh has one member and nothing crosses processes.

Each process holds its own shard of the batch (``shard_batch`` puts it on the
process's device). The trainers make the step equal to the JAX package's step
over the joined batch in two moves:

- :func:`gather` joins a tensor's shards along its batch axis before the
  loss, so that every batch-coupled reduction of the loss (the magnitude
  normalisation's maximum, the weighted cross-entropy's ratio, SSIM's and
  Dice's batch terms) sees the whole batch, as under XLA. Every process then
  computes the same loss of the joined batch; the backward of the gather
  hands each process the gradient of its own rows only.
- :func:`all_reduce_gradients` sums the processes' parameter gradients (one
  flat all-reduce a dtype, in the parameters' order). Each process's
  gradient is the part of the joined loss's gradient that flows through its
  own rows, so the sum is the joined loss's gradient: no rescaling.

One test decides whether anything joins the processes: :func:`joins_processes`,
a default process group of more than one process. The trainers' gather reads
it, and so do the models' own batch-coupled reductions (training and
evaluation alike, as the JAX package computes them over its mesh): a live
BatchNorm's statistics in train mode and the conjugate gradient's inner
products (``models/recon/resnet.py:cdot``) are sums over the processes
(:func:`all_reduce_sum`, whose backward sums the gradients again), and the
multitask models' normalisation by the maximum of the whole tensor takes the
maximum over the processes (:func:`joined_amax`). At one process none of
this runs: ``gather`` returns its input and the reductions are local. Only
the gradients' sum runs in a group of one process too (its collective then
returns its input), so that a one-card group shows its backend at work; and
a trainer takes no mesh but the one :func:`make_mesh` gives for the group
that stands, so that its step and its model join the same processes.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated", "shard_batch", "data_parallel_shardings",
           "NON_BATCH_LEAVES", "Sharding", "gather", "all_reduce_sum", "all_reduce_gradients", "broadcast_module",
           "COLLECTIVES", "distributed_world", "joins_processes", "joined_amax"]

# collectives issued by this module, by kind (the card's check reads them)
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def distributed_world() -> int:
    """The default process group's size; 0 when no group is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def joins_processes() -> bool:
    """True when a default process group of more than one process stands:
    then the step's tensors and the models' batch-coupled reductions are
    joined over its processes."""
    return distributed_world() > 1


def _group_device() -> torch.device:
    """This process's device: the current card under NCCL, the CPU under
    another backend, the current card (else the CPU) without a group."""
    if distributed_world():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")


@dataclass(frozen=True)
class Mesh:
    """The ``data`` axis of the default process group: ``shape`` maps each
    axis name to its size (the first axis is the world size, the others 1
    unless a shape was given), ``rank`` is this process's place on it and
    ``device`` its device. ``distributed`` is True when a process group
    stands behind the mesh (even of one process: its collectives then run)."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    distributed: bool = False

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


@dataclass(frozen=True)
class Sharding:
    """A leaf's placement on a mesh: ``spec`` names the mesh axis its batch
    axis is split over, ``()`` for a leaf every process holds whole."""

    mesh: Mesh
    spec: Tuple[str, ...] = ()


def make_mesh(num_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """The mesh of the default process group (one member without a group):
    a 1D ``data`` axis by default; with ``shape`` and ``axis_names`` a
    layout whose product is the world size. Raises when ``num_devices`` or
    ``shape`` ask for another number of processes than the group holds."""
    world = distributed_world()
    n_procs = world or 1
    if shape is not None:
        n = int(np.prod(shape))
        if num_devices is not None and num_devices != n:
            raise ValueError(f"num_devices={num_devices} inconsistent with shape {shape} (prod={n})")
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axis_names {tuple(axis_names)} differ in length")
    else:
        n = n_procs if num_devices is None else int(num_devices)
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if n != n_procs:
        raise ValueError(f"requested a mesh of {n} processes, the process group holds {n_procs} (one process "
                         "drives one card: start one process a member, e.g. with torchrun)")
    return Mesh(shape=dict(zip(axis_names, (int(s) for s in shape))), rank=dist.get_rank() if world else 0,
                device=_group_device(), distributed=bool(world))


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Leading-axis (batch) sharding over ``axis``."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def data_parallel_shardings(mesh: Mesh) -> Tuple[Sharding, Sharding]:
    """(replicated parameters, batch-sharded data)."""
    return replicated(mesh), batch_sharding(mesh)


# Leaves whose dim0 is NOT a batch axis: per-echo/scalar metadata shared by
# every sample ("TEs" is [num_echoes] echo times). They are replicated by
# declaration, not by the divisibility-warning fallback.
NON_BATCH_LEAVES = frozenset({"TEs", "acceleration_choices", "attrs"})

_warned_replicated: Dict[str, bool] = {}


def shard_batch(batch: Dict, mesh: Mesh, axis: str = "data", replicated_keys: frozenset = NON_BATCH_LEAVES) -> Dict:
    """This process's shard of the batch on the mesh's device: every array
    leaf (numpy or tensor) is put there. Leaves named in
    ``replicated_keys`` are whole on every process, silently; a leaf whose
    batch axis does not divide by the axis size is warned about once (the
    joined batch of the processes is then uneven: the loaders pad their
    shards to one length, so use them, drop_last or a divisible batch size).
    Non-array leaves (file names, attrs) pass through untouched."""
    size = mesh.shape[axis]
    out = {}
    for k, v in batch.items():
        is_array = isinstance(v, (np.ndarray, torch.Tensor))
        if not is_array:
            out[k] = v
            continue
        if k not in replicated_keys and (v.ndim == 0 or v.shape[0] % size) and not _warned_replicated.get(k):
            _warned_replicated[k] = True
            logging.getLogger("mridc_tpu").warning(
                f"batch leaf {k!r} (dim0={v.shape[0] if v.ndim else 0}) is not divisible by the {axis}-axis size "
                f"{size}: the joined batch is uneven. Use drop_last or a divisible batch size.")
        out[k] = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), device=mesh.device)
    return out


# ---- collectives with gradients ----


class _Gather(torch.autograd.Function):
    """All processes' ``x`` joined along ``axis`` (equal shapes on every
    process). The backward takes this process's rows of the upstream
    gradient: as they are where every process computes the same function of
    the joined tensor (the loss), so that they are the whole gradient of the
    local rows; summed over the processes first (``sum_grads``) where each
    process uses the joined tensor in a function of its own."""

    @staticmethod
    def forward(ctx, x, axis, sum_grads):
        world, rank = dist.get_world_size(), dist.get_rank()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        COLLECTIVES["all_gather"] += 1
        ctx.axis, ctx.rank, ctx.n, ctx.sum_grads = axis, rank, x.shape[axis], sum_grads
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = g.contiguous().clone()
            dist.all_reduce(g)
            COLLECTIVES["all_reduce"] += 1
        return g.narrow(ctx.axis, ctx.rank * ctx.n, ctx.n), None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the processes; its backward sums the upstream
    gradients over them (each process's ``x`` reaches every process's
    output)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        COLLECTIVES["all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        COLLECTIVES["all_reduce"] += 1
        return g


def gather(x: Optional[torch.Tensor], axis: int = 0) -> Optional[torch.Tensor]:
    """``x`` joined over the default process group's processes along
    ``axis`` (its batch axis), differentiably; ``x`` itself (None stays None)
    unless :func:`joins_processes`."""
    if x is None or not joins_processes():
        return x
    return _Gather.apply(x, axis % x.ndim, False)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the default process group, differentiably (the
    identity unless :func:`joins_processes`)."""
    if not joins_processes():
        return x
    return _AllReduceSum.apply(x)


def joined_amax(x: torch.Tensor) -> torch.Tensor:
    """The maximum of ``x`` over all its elements and over the default
    process group's processes, differentiably (``torch.amax`` without a
    group of more than one process); ties split the gradient, as ``amax``
    splits it."""
    local = torch.amax(x)
    if not joins_processes():
        return local
    return torch.amax(_Gather.apply(local.reshape(1), 0, True))


def all_reduce_gradients(params: Sequence[torch.Tensor]) -> None:
    """Sum every parameter's ``.grad`` over the default process group: one
    flat all-reduce per gradient dtype, the parameters in their order, the
    sums written back into the gradients. Every gradient must be set. A
    group of one process runs the collective too; without a group nothing
    runs."""
    if not distributed_world():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        COLLECTIVES["all_reduce"] += 1
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to process ``src``'s
    (the processes then start from one set of weights); nothing unless
    :func:`joins_processes`."""
    if not joins_processes():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
            COLLECTIVES["broadcast"] += 1
