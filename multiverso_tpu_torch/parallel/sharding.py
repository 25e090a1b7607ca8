"""Placement helpers and the named process mesh — the port of
``multiverso_tpu/parallel/sharding.py``.

In the JAX package a table or a weight picks a ``NamedSharding`` over a
``jax.sharding.Mesh`` of devices, and XLA materializes the partitioning
and the collectives (the reference's ``WorkerTable::Partition`` over
server processes; SURVEY.md §2.10).  The port runs one process per card,
so the mesh becomes :class:`Mesh`: one ``torch.distributed`` group per
named axis, and each process knows its coordinate on every axis.  A
process holds only its own shard of a tensor; :func:`local_shard` and
:func:`gather_full` stand in for placing an array with a
``NamedSharding`` and for fetching the global array back.

The port's own class rather than ``torch.distributed.device_mesh.
DeviceMesh``: the collectives of the port name groups by axis and send
point to point to a neighbour's global rank, which is all a mesh has to
give, and the same class runs over gloo on the CPU and NCCL on the card.

The tables shard over the ranks of the default process group, as the
JAX package's tables shard over its 1-D table mesh: ``table_mesh`` is
the rank's device, ``shard_along`` the :class:`TableShard` of a table's
leading dimension on it (one process: the whole table).  Every table
asks its shard for its block's size and offset and for the owner of a
row; :func:`is_multiprocess`, the one predicate behind every collective
of the tables, says whether they shard at all.  ``batch_placer`` moves
a batch onto the device.  ``replicated`` and
``host_to_global`` have no counterpart: a replicated tensor is an
ordinary tensor on every rank, and a global array is never assembled
except by :func:`gather_full` (a mesh) or a table's gather of its
shards (``tables/base.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "local_shard", "gather_full", "shard_leaf",
           "gather_leaf", "table_mesh", "shard_along", "TableShard",
           "batch_placer", "is_multiprocess"]

Device = Union[str, torch.device]
# Where a leaf of a parameter tree lives on a mesh: ``(dim, axis)``, its
# dimension ``dim`` split in contiguous blocks over ``axis``, or None,
# replicated (the port's spelling of a ``PartitionSpec``).
Spec = Optional[Tuple[int, str]]


class Mesh:
    """Named axes over an initialized ``torch.distributed`` group.

    Ranks fill the axis grid in row-major order, as ``make_mesh`` of the
    JAX package reshapes its device list: the last axis varies fastest.
    ``shape`` maps each axis to its size (as ``jax.sharding.Mesh.shape``
    does); :meth:`index`, :meth:`size`, :meth:`group` and :meth:`peer`
    answer for this rank.  An axis the mesh does not name has size 1 and
    index 0.  Building a mesh is a collective: every rank builds the
    same one, in the same order.
    """

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 device: Optional[Device] = None):
        import torch.distributed as dist

        sizes = tuple(int(s) for s in axis_sizes)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis sizes {sizes} and names {names} do not "
                             "pair up one to one")
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a Mesh needs an initialized torch.distributed "
                               "process group (one process per card)")
        world = dist.get_world_size()
        n = int(np.prod(sizes))
        if n != world:
            raise ValueError(f"mesh {sizes} needs {n} processes, have "
                             f"{world}")
        self.rank = dist.get_rank()
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        grid = np.arange(world).reshape(sizes)
        self._index = {a: int(i) for a, i in
                       zip(names, np.unravel_index(self.rank, sizes))}
        self._grid, self._groups, self._ranks = grid, {}, {}
        for axis in names:
            self._groups[axis], self._ranks[axis] = self._new_group((axis,))
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)   # NCCL's current device

    def __contains__(self, axis: str) -> bool:
        return axis in self.shape

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self._index.get(axis, 0)

    def _new_group(self, axes: Tuple[str, ...]):
        """Every group over ``axes`` (all other coordinates fixed), built
        on every rank in one order; returns this rank's and its ranks."""
        import torch.distributed as dist

        names = list(self.shape)
        at = [names.index(a) for a in axes]
        n = int(np.prod([self.shape[a] for a in axes]))
        lines = np.moveaxis(self._grid, at, list(range(-len(at), 0)))
        mine = None
        for line in lines.reshape(-1, n):
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks)         # collective: every rank
            if self.rank in ranks:
                mine = group, ranks
        return mine

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def group_over(self, axes: Sequence[str]):
        """This rank's process group over the product of ``axes`` (all
        named by the mesh, in mesh order).  The first call for a set of
        axes builds its groups: a collective, which every rank makes with
        the same axes."""
        axes = tuple(a for a in self.shape if a in axes)
        if len(axes) == 1:
            return self._groups[axes[0]]
        if axes not in self._groups:
            self._groups[axes], self._ranks[axes] = self._new_group(axes)
        return self._groups[axes]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in axis
        order."""
        return list(self._ranks[axis])

    def peer(self, axis: str, offset: int) -> int:
        """Global rank of the process ``offset`` steps along ``axis``
        (cyclic)."""
        ranks = self._ranks[axis]
        return ranks[(self.index(axis) + offset) % len(ranks)]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device: Optional[Device] = None) -> Mesh:
    """Build a named process mesh, e.g. ``make_mesh((2, 2), ("dp",
    "tp"))`` over four processes.  ``device`` defaults to the rank's own
    card, which becomes the current CUDA device."""
    return Mesh(axis_sizes, axis_names, device)


def local_shard(full: torch.Tensor, dim: int, axis: str,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous block of ``full`` along ``dim`` when ``dim``
    is sharded over ``axis`` (``full`` itself without a mesh or for an
    axis of one)."""
    n = 1 if mesh is None else mesh.size(axis)
    if n == 1:
        return full
    if full.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {full.shape[dim]} does "
                         f"not divide over {axis} ({n})")
    step = full.shape[dim] // n
    return full.narrow(dim, mesh.index(axis) * step, step)


def gather_full(local: torch.Tensor, dim: int, axis: str,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """Inverse of :func:`local_shard`: every rank's block along ``axis``
    concatenated on ``dim`` (a collective over that axis's group).  Gloo
    gathers no CUDA tensors, so under gloo a card's block is staged
    through the host."""
    import torch.distributed as dist

    n = 1 if mesh is None else mesh.size(axis)
    if n == 1:
        return local
    group = mesh.group(axis)
    local = local.detach().contiguous()
    staged = local.is_cuda and dist.get_backend(group) == "gloo"
    send = local.cpu() if staged else local
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim).to(local.device)


def shard_leaf(full: torch.Tensor, spec: Spec,
               mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of a leaf placed by ``spec`` (``full`` itself
    when replicated): the tp blocks of the Megatron layout, or an MoE
    layer's experts ``[E, ...]`` split over ``ep``."""
    if spec is None:
        return full
    dim, axis = spec
    return local_shard(full, dim, axis, mesh)


def gather_leaf(local: torch.Tensor, spec: Spec,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """Inverse of :func:`shard_leaf`: the whole leaf on every rank (a
    collective over ``spec``'s axis)."""
    if spec is None:
        return local
    dim, axis = spec
    return gather_full(local, dim, axis, mesh)


def table_mesh(device: Optional[Device] = None) -> torch.device:
    """The device this rank's table shards live on: the context's
    device, or the rank's card (raising without one) when none is given.
    The mesh's ranks are those of the default process group."""
    return resolve_device(device)


class TableShard(NamedTuple):
    """This rank's block of a table's leading dimension (rows, or an
    array's elements): the one spelling of a shard's size, offset and
    owned rows that every table uses.

    ``rows`` live rows pad to ``padded = ceil(rows / world) * world``, as
    the JAX package pads a table to its mesh; rank ``r`` holds rows
    ``[r * size, (r + 1) * size)`` with ``size = padded / world``.  Rows
    past ``rows`` are padding: no add may write one, no read returns
    one.  One process: ``world`` 1, the whole table."""

    device: torch.device
    rows: int
    world: int = 1
    rank: int = 0

    @property
    def padded(self) -> int:
        return -(-self.rows // self.world) * self.world

    @property
    def size(self) -> int:
        return self.padded // self.world

    @property
    def offset(self) -> int:
        return self.rank * self.size

    @property
    def sharded(self) -> bool:
        return self.world > 1

    def owned(self, rows):
        """Which of ``rows`` (numpy or tensor ids) are live rows of this
        rank's block: the rows this rank owns (row ``i``'s owner is rank
        ``i // size``)."""
        return (rows >= self.offset) & (rows < self.offset + self.size) \
            & (rows < self.rows)

    def block(self, full: Optional[np.ndarray], dtype,
              rest: Tuple[int, ...] = ()) -> np.ndarray:
        """This rank's block as a fresh host array of ``size`` rows:
        ``full``'s live rows that fall in it (``full`` holds at least the
        live rows; ``None`` reads zeros), zeros in the padding."""
        out = np.zeros((self.size,) + tuple(rest), dtype=dtype)
        hi = min(self.offset + self.size, self.rows)
        if full is not None and hi > self.offset:
            src = np.asarray(full, dtype)
            if src.ndim <= len(rest):      # a row or a scalar: every row
                src = np.broadcast_to(src, (self.rows,) + tuple(rest))
            out[:hi - self.offset] = src[self.offset:hi]
        return out


def is_multiprocess() -> bool:
    """One predicate for every lockstep-collective guard in the tables.

    All multi-process paths (``multihost_sum``/the gathers/the barrier,
    a table's shard) MUST use this same test — two spellings that ever
    diverged would leave one rank inside a collective the other skipped:
    deadlock.
    """
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def shard_along(device: Device, rows: int) -> TableShard:
    """The shard of a table with ``rows`` leading rows over the ranks of
    the default process group (:func:`is_multiprocess`), on ``device``:
    the whole table in one process."""
    import torch.distributed as dist

    if not is_multiprocess():
        return TableShard(torch.device(device), int(rows))
    return TableShard(torch.device(device), int(rows),
                      dist.get_world_size(), dist.get_rank())


def batch_placer(device: Device, batch_axis: str = "worker", dtype=None):
    """Build the batch-placing closure the apps' fused steps use.

    Returns ``(axis_name, place)`` like the JAX package; ``place(a)``
    is ``torch.as_tensor(a, dtype)`` moved onto ``device``.
    """
    device = torch.device(device)

    def place(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return batch_axis, place
