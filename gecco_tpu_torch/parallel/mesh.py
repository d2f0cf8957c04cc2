"""Process group, mesh and sharding helpers (counterpart of
``gecco_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, seq)`` mesh and lets XLA
insert the collectives. Here every rank is one process of a
``torch.distributed`` group with the whole model on its own card, laid out
as the JAX mesh's ``reshape(data, seq)``: rank ``d * seq + s`` sits at
``data`` index d and ``seq`` index s. The port does by hand what XLA
inserts:

- each data row of ranks trains on its rows of the global batch
  (``shard_batch``, or a loader built with ``shard_by_process=True`` that
  reads only those rows);
- with ``shard_points`` the ``seq`` ranks of a row each hold a slice of
  every cloud's points, and the model's point reductions issue their
  collectives over the row's ``seq`` group (``parallel.collectives``);
- after the backward the gradients are averaged over the whole world
  (``all_reduce_mean_``: one all-reduce per dtype over one flat buffer),
  so every rank takes the same optimizer step and keeps the same weights;
- the weights start equal: ``replicate`` broadcasts them from rank 0.

A world of one issues no collective at all.

The backend is NCCL on the card and gloo on the CPU unless the caller names
one. gloo also takes CUDA tensors (it stages them through the host itself),
which is how two ranks share one card: NCCL refuses two ranks on one
device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from gecco_tpu_torch.types import Example, to_device, tree_leaves, tree_map
from gecco_tpu_torch.utils.modules import resolve_device

__all__ = [
    "Mesh",
    "all_reduce_mean_",
    "init_distributed",
    "local_device",
    "make_mesh",
    "process_count",
    "process_index",
    "replicate",
    "shard_batch",
    "shutdown_distributed",
]

def init_distributed(**kwargs) -> int:
    """Join the process group (one call per process, before any device use)
    and return this process's rank.

    With no arguments the group comes from the launcher's environment
    (``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``); ``kwargs`` go to
    ``init_process_group`` (``backend``, ``init_method``, ``world_size``,
    ``rank``, ...). The backend is NCCL where a card is present and gloo
    otherwise, unless ``backend`` names one. A second call is a no-op; a
    call without arguments outside any launcher stays single-process and
    returns 0; explicit arguments that fail raise.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if not kwargs and "WORLD_SIZE" not in os.environ:
        return 0
    backend = kwargs.pop("backend", None)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend=backend, **kwargs)
    return dist.get_rank()


def shutdown_distributed() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_device(device=None) -> torch.device:
    """The device this rank runs on: ``resolve_device(device)`` (the card
    unless the caller names another, raising where there is none); a card
    named without an index is, under a group of more than one,
    ``cuda:{LOCAL_RANK % device_count}``, so ranks beyond the cards share
    them."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        index = _local_rank() % torch.cuda.device_count() if process_count() > 1 else 0
        dev = torch.device("cuda", index)
    return dev


@dataclass(frozen=True)
class Mesh:
    """The ``(data, seq)`` layout over the default process group: ``data``
    rows of ``seq`` ranks, each rank holding the whole model; a row's ranks
    share ``1 / data`` of the batch, and with ``shard_points`` each holds
    ``1 / seq`` of its points. ``rank`` is this process's global rank,
    ``seq_group`` its row's group (None where ``seq`` is 1)."""

    data: int = 1
    seq: int = 1
    rank: int = 0
    seq_group: Any = field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        return self.data * self.seq

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis: which rows it holds."""
        return self.rank // self.seq

    @property
    def seq_index(self) -> int:
        """This rank's place on the seq axis: which points it holds."""
        return self.rank % self.seq

    @property
    def is_main(self) -> bool:
        """True on the rank that writes checkpoints, logs and metadata."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank (nothing on a world of one)."""
        if self.size > 1:
            dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank; ``obj``
        itself on a world of one."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(data: Optional[int] = None, seq: int = 1) -> Mesh:
    """The ``(data, seq)`` mesh over the process group (a world of one
    without a group): ``data`` defaults to the group's size over ``seq``,
    and ``data * seq`` must equal the size. Where ``seq > 1`` every rank
    makes every row's group, in the same order (``dist.new_group`` is
    collective), and keeps its own."""
    world = process_count()
    if seq < 1:
        raise ValueError(f"seq must be at least 1, got {seq}")
    if data is None:
        data = world // seq
    if data * seq != world:
        raise ValueError(f"mesh {data}x{seq} != {world} processes")
    rank = process_index()
    seq_group = None
    if seq > 1:
        for d in range(data):
            group = dist.new_group(list(range(d * seq, (d + 1) * seq)))
            if d == rank // seq:
                seq_group = group
    return Mesh(data=data, seq=seq, rank=rank, seq_group=seq_group)


def _cut(x, index: int, count: int, axis: int, what: str):
    """Part ``index`` of ``count`` equal parts of ``x`` along ``axis``."""
    if count == 1 or not hasattr(x, "shape") or len(x.shape) <= axis:
        return x
    size = x.shape[axis]
    if size % count:
        raise ValueError(f"{what} {size} not divisible by {count} ranks")
    part = size // count
    return x[(slice(None),) * axis + (slice(index * part, (index + 1) * part),)]


def _rows(x, mesh: Mesh):
    """The rank's rows of a global batch leaf."""
    return _cut(x, mesh.data_index, mesh.data, 0, "global batch")


def _points(x, mesh: Mesh):
    """The rank's points of a ``[B, N, ...]`` leaf."""
    return _cut(x, mesh.seq_index, mesh.seq, 1, "point count")


def shard_batch(batch, mesh: Mesh, device=None, local: bool = False,
                shard_points: bool = False):
    """A batch on ``device`` (``local_device``'s default), this rank's part.

    On a world of one this is a plain move. Otherwise a global batch (an
    ``Example``, or any record of arrays with the batch axis first) is cut
    to the rank's rows, by its data index: the points and every ``ctx`` and
    ``extras`` leaf along their batch axis. ``local=True`` says the rows
    are the rank's already (a ``DataLoader(shard_by_process=True)`` batch):
    they pass through uncut, as the JAX package takes process-local arrays.

    ``shard_points=True`` (under ``seq > 1``) also cuts the points along
    their second axis, by the rank's seq index, ``local`` or not. Of an
    ``Example`` only the points are cut so: the ``ctx`` and ``extras``
    leaves (images, intrinsics) are replicated along ``seq``, as in the JAX
    package; of any other record every leaf is.
    """
    device = local_device(device)
    if mesh.data > 1 and not local:
        batch = tree_map(lambda x: _rows(x, mesh), batch)
    if shard_points and mesh.seq > 1:
        if isinstance(batch, Example):
            batch = batch._replace(points=_points(batch.points, mesh))
        else:
            batch = tree_map(lambda x: _points(x, mesh), batch)
    return to_device(batch, device)


def _on_flat(tensors: Iterable[torch.Tensor], op) -> None:
    """``op`` in place on one flat copy of the tensors of each (device,
    dtype), copied back after."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce (a sum, then a division by the world size) per dtype over
    one flat buffer. Nothing happens on a world of one."""
    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.size)

    if mesh.size > 1:
        _on_flat(tensors, mean)


def replicate(tree, mesh: Mesh):
    """Every rank's copy of ``tree`` made equal to rank 0's, in place, and
    returned: a module's parameters and buffers, or every tensor leaf of a
    record (the optimizer state). One broadcast per dtype over one flat
    buffer; nothing happens on a world of one."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    with torch.no_grad():
        _on_flat(tensors, lambda flat: dist.broadcast(flat, src=0))
    return tree
