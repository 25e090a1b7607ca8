"""Pipeline parallelism — GPipe over a mesh axis.

Port of ``multiverso_tpu/parallel/pipeline.py``.  The JAX package writes
the schedule as pure SPMD: one ``shard_map`` over ``pp`` and a
``lax.scan`` of ``M + pp - 1`` ticks in which every stage computes (on
garbage in the bubble) and ``ppermute`` rotates the activations.  Here
each stage is a process: the same ``M + pp - 1`` ticks, in which stage s
works on microbatch ``t - s`` when there is one and idles otherwise.
Stage 0 injects microbatch t; every other stage receives its input from
the stage before (:func:`.collectives.recv_forward`) and every stage but
the last sends its output on (:func:`.collectives.send_forward`); the
last stage banks its outputs, and :func:`.collectives.
broadcast_from_last` gives them to every stage, as the JAX package's
``psum`` of one-hot banks does.

The backward is autograd's: each send's backward receives the
gradient from the next stage, each receive's backward sends it back.
Every stage's backward runs its microbatches last to first (autograd
takes the newest ready node first), so neighbouring stages pair their
point-to-point calls in one order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..util.tree import tree_map
from .collectives import broadcast_from_last, recv_forward, send_forward

__all__ = ["gpipe", "stage_slice"]


def stage_slice(n_layers: int, mesh, axis_name: str = "pp") -> slice:
    """The layers this rank's stage holds (the port's ``stage_pspec``:
    the stacked layer dim split over ``axis_name``)."""
    pp = 1 if mesh is None else mesh.size(axis_name)
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers do not divide into {pp} "
                         "stages")
    per = n_layers // pp
    s = 0 if mesh is None else mesh.index(axis_name)
    return slice(s * per, (s + 1) * per)


def _tensor_leaves(tree) -> list:
    found = []
    tree_map(lambda a: found.append(a) if isinstance(a, torch.Tensor)
             else None, tree)
    return found


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, x: torch.Tensor, mesh,
          axis_name: str = "pp", remat_stages: bool = False
          ) -> torch.Tensor:
    """Run ``x`` through the ``pp`` stages of ``axis_name``, microbatched.

    - ``stage_fn(stage_params, h) -> h``: this rank's stage (its block of
      layers); must keep ``h``'s shape and dtype.
    - ``stage_params``: this rank's stage weights (a tree), e.g. its
      :func:`stage_slice` of the layers.
    - ``x``: [M, Bm, ...] microbatches, the same on every stage (only
      stage 0 reads it).  Returns [M, Bm, ...]: each microbatch after all
      stages, on every stage.
    - ``remat_stages``: wrap each tick's stage in
      ``torch.utils.checkpoint``, so only each stage's input survives to
      the backward (the JAX package's 1F1B memory profile).

    Data parallelism needs nothing here: each dp rank runs its own
    pipeline on its own rows, and the trainer sums the gradients."""
    pp = mesh.size(axis_name)
    M = x.shape[0]
    s = mesh.index(axis_name)
    if remat_stages:
        def tick_fn(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)
    else:
        tick_fn = stage_fn
    leaves = [a for a in _tensor_leaves(stage_params) if a.requires_grad]
    anchor = leaves[0] if leaves else x
    outs, tokens = [], []
    for t in range(M + pp - 1):
        m = t - s                        # the microbatch this stage does
        if not 0 <= m < M:
            continue                     # the bubble: nothing to do
        if s == 0:
            h = x[m]
        else:
            h = recv_forward(anchor, x.shape[1:], x.dtype, mesh, axis_name)
        h = tick_fn(stage_params, h)
        if s < pp - 1:
            tokens.append(send_forward(h, mesh, axis_name))
        else:
            outs.append(h)
    if pp == 1:
        return torch.stack(outs)
    bank = torch.stack(outs) if outs else torch.zeros_like(x)
    return broadcast_from_last(bank, tokens, mesh, axis_name)
