"""Attention dispatch of the PyTorch port (single device; the
sequence-parallel ring is not ported yet)."""

from .ring_attention import blockwise_attention_local

__all__ = ["blockwise_attention_local"]
