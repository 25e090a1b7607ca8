"""multiverso_tpu_torch — the PyTorch/CUDA port of multiverso_tpu.

A second package beside the JAX one, for one NVIDIA H100 (Hopper).  This
first slice carries the transformer trainer: the server-side updaters,
the Llama-style model, and the three flash-attention kernels written by
hand in CUDA C++ for ``sm_90a`` (``ops/csrc/``).  The tables, clocks and
apps of the JAX package come in later slices (ROADMAP.md).

It imports ``torch`` and never ``jax``, and nothing of ``multiverso_tpu``.
Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

from . import dashboard, metrics, models, ops, tracing
from .device import resolve_device
from .log import Log
from .updaters import AddOption, GetOption, get_updater

__version__ = "0.1.0"

__all__ = [
    "AddOption", "GetOption", "get_updater", "dashboard", "Log", "models",
    "ops", "resolve_device", "metrics", "tracing",
]
