"""Placement and attention dispatch of the PyTorch port (one device per
process; the sequence-parallel ring is not ported yet)."""

from .ring_attention import blockwise_attention_local
from .sharding import batch_placer, shard_along, table_mesh

__all__ = ["batch_placer", "blockwise_attention_local", "shard_along",
           "table_mesh"]
