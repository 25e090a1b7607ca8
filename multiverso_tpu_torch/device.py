"""Where the port runs.

The JAX package picks a ``jax.sharding.Mesh`` (``models/transformer.py``
trainer, ``parallel/sharding.py``); on one H100 the mesh collapses to a
single ``torch.device``.  Entry points run on the card unless the caller
names another device (the CPU tests pass ``device="cpu"``): a missing
card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda:0`` (raises when CUDA is absent); anything else
    is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multiverso_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)
