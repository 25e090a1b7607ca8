"""Kernels of the PyTorch port (CUDA C++ under ``csrc/``, built on first
use by ``_build.py``) and their plain PyTorch versions.  The attention
function itself is ``ops.flash_attention.flash_attention``."""

from . import flash_attention
from .flash_attention import launch_counts, reset_launch_counts

__all__ = ["flash_attention", "launch_counts", "reset_launch_counts"]
