"""Where the port runs.

The JAX package picks a ``jax.sharding.Mesh`` (``models/transformer.py``
trainer, ``parallel/sharding.py``); the port runs one process per card,
so each process's mesh collapses to a single ``torch.device``.  Entry
points run on the card unless the caller names another device (the CPU
tests pass ``device="cpu"``): a missing card is an error, never a silent
fall back to the CPU.

Under an initialized process group every rank takes its own card:
``LOCAL_RANK`` (what ``torchrun`` sets) names it, else the global rank
modulo the cards on the node.  NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import torch

__all__ = ["resolve_device", "rank_device_index"]


def rank_device_index(rank: int, device_count: int,
                      environ: Optional[Mapping[str, str]] = None) -> int:
    """The card of a rank on its node: ``LOCAL_RANK`` when set, else
    ``rank % device_count``."""
    environ = os.environ if environ is None else environ
    local = environ.get("LOCAL_RANK")
    if local is not None and local != "":
        return int(local)
    if device_count < 1:
        raise RuntimeError("no CUDA device to place this rank on")
    return rank % device_count


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → this rank's card (``cuda:0`` outside a process group;
    raises when CUDA is absent); anything else is taken as the caller's
    explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multiverso_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", rank_device_index(
                dist.get_rank(), torch.cuda.device_count()))
        return torch.device("cuda", 0)
    return torch.device(device)
