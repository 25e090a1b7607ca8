"""Table placement helpers — the port of ``multiverso_tpu/parallel/sharding.py``.

In the JAX package a table picks a ``NamedSharding`` over a 1-D mesh of
every device and XLA materializes the partitioning (the reference's
``WorkerTable::Partition`` over server processes; SURVEY.md §2.10).  The
port runs one device per process, so each helper collapses to that
device: ``table_mesh`` and ``shard_along`` return it, and
``batch_placer`` moves a batch onto it.

``make_mesh``, ``replicated`` and ``host_to_global`` have no
counterpart: there is no multi-device mesh to build or replicate over
and no global array to assemble (under several processes each one holds
a full table replica; see ``tables/base.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import resolve_device

__all__ = ["table_mesh", "shard_along", "batch_placer"]

_SHARD_AXIS = "shard"

Device = Union[str, torch.device]


def table_mesh(device: Optional[Device] = None) -> torch.device:
    """The device tables live on: the context's device, or ``cuda:0``
    (raising without a card) when none is given."""
    return resolve_device(device)


def shard_along(device: Device, ndim: int, dim: int = 0,
                axis: str = _SHARD_AXIS) -> torch.device:
    """One device holds the whole array: every dimension is "sharded"
    over a mesh of one."""
    return torch.device(device)


def batch_placer(device: Device, batch_axis: str = "worker", dtype=None):
    """Build the batch-placing closure the apps' fused steps use.

    Returns ``(axis_name, place)`` like the JAX package; ``place(a)``
    is ``torch.as_tensor(a, dtype)`` moved onto ``device``.
    """
    device = torch.device(device)

    def place(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return batch_axis, place
