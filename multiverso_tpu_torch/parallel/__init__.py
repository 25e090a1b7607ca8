"""Placement, the named process mesh, its collectives, ring attention and
the GPipe pipeline of the PyTorch port.

The port runs one process per card; the JAX package's named mesh axes
(dp, tp, sp, pp, ep) become one ``torch.distributed`` group per axis
(:class:`Mesh`).  ``OffloadedState`` is the trainer's state bridge
(the native store or the local one; ``offload.py``).
``parallel/_compat.py`` of the JAX package (its
``shard_map`` shim across JAX versions) has no counterpart: there is no
``shard_map`` here — each process already runs the per-shard body, and
``collectives.py`` holds the communication GSPMD and ``shard_map``
inserted there.
"""

from .offload import OffloadedState
from .pipeline import gpipe, stage_slice
from .ring_attention import (InProcessRing, blockwise_attention_local,
                             ring_attention, ring_attention_shard,
                             sequence_positions)
from .sharding import (Mesh, TableShard, batch_placer, gather_full,
                       local_shard, make_mesh, shard_along, table_mesh)

__all__ = ["InProcessRing", "Mesh", "OffloadedState", "batch_placer",
           "blockwise_attention_local", "gather_full", "gpipe",
           "local_shard", "make_mesh", "ring_attention",
           "ring_attention_shard", "sequence_positions", "shard_along",
           "stage_slice", "table_mesh", "TableShard"]
