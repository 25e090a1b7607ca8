"""Mixture-of-Experts feed-forward for the PyTorch port.

Port of ``multiverso_tpu/models/moe.py``: the router, the load-balancing
loss and the two dispatch schedules, over a dictionary of float32 master
weights (``router`` ``[dim, E]``, ``w1``/``w3`` ``[E, dim, hidden]``,
``w2`` ``[E, hidden, dim]``).  The JAX package runs all of it as XLA
einsums, gathers and scatters, outside any Pallas kernel, so here it is
plain PyTorch.

On a mesh of processes (``parallel.sharding.Mesh``) the layer computes
what GSPMD computes for the JAX package from ``moe_pspecs``: the experts
``[E, ...]`` split over ``ep`` (:func:`moe_pspecs`/:func:`moe_shardings`),
the router replicated, nothing split over ``tp`` (each tp rank runs the
layer whole); the tokens split over ``dp`` and ``sp`` and replicated
over ``ep`` and ``tp``.  A :class:`TokenShard` says where a rank's
tokens sit in the global batch.  The math stays global:

- the load-balancing loss takes its two means over the global batch and
  sequence: each rank's sums are summed over dp and sp with the identity
  backward (``collectives.reduce_over``), so each rank differentiates
  its own tokens' share and the loss counts it once;
- the capacity is ``moe_capacity`` of the global token count, and the
  slots go token-major over the global flat (b, t) order: the ranks'
  expert ids are gathered in that order (``collectives.gather_routes``),
  every rank plans every bucket alike and keeps its own routes' slots;
- each rank computes its ``E/ep`` experts and the outputs sum over ep
  (``reduce_from``).  The experts' input and the combine weights pass
  ``copy_to`` over ep, whose backward sums the ranks' partial gradients:
  the router's gradient comes out whole on every ep rank, and is summed
  over no other axis than dp and sp.

A rank's buckets hold only its own routes, other slots zero: an expert
runs ``C`` rows on each dp/sp rank, where one process runs them once.

The capacity schedule keeps the JAX package's slot order (token-major:
earlier tokens win a bucket's slots) and its bucket size, but fills the
buckets by gathering: every slot reads the one route that owns it, and a
route past its expert's capacity is dropped, never written to a spare
row.  No two routes meet in one row, so the result does not depend on
the order in which a card's atomics land.  Nothing here waits for the
device: no op whose output size depends on the data (``bincount``, a
boolean index, ``repeat_interleave`` by a tensor), so a step's launches
queue ahead of the card.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import (copy_to, gather_routes, reduce_from,
                                    reduce_over)
from ..parallel.sharding import shard_leaf

__all__ = ["init_moe_params", "moe_capacity", "moe_ffn", "capacity_plan",
           "moe_pspecs", "moe_shardings", "TokenShard"]

# The axes a layer's tokens split over; they are replicated over the rest.
TOKEN_AXES = ("dp", "sp")


def init_moe_params(dim: int, hidden: int, num_experts: int,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """Float32 expert weights on the host, drawn as the JAX package draws
    them: the same seed gives the same weights in both packages."""
    rng = np.random.RandomState(seed)

    def w(*shape, scale):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))

    return {
        "router": w(dim, num_experts, scale=0.02),
        "w1": w(num_experts, dim, hidden, scale=dim ** -0.5),   # gate
        "w3": w(num_experts, dim, hidden, scale=dim ** -0.5),   # up
        "w2": w(num_experts, hidden, dim, scale=hidden ** -0.5),
    }


def moe_pspecs(mesh=None) -> Dict[str, Any]:
    """Where each leaf lives on ``mesh`` (the port's spelling of a
    ``PartitionSpec``: ``(dim, axis)`` or None, replicated): the experts
    split their leading ``E`` over ``ep`` when the mesh has one; the
    router is replicated."""
    ep = (0, "ep") if mesh is not None and "ep" in mesh else None
    return {"router": None, "w1": ep, "w3": ep, "w2": ep}


def moe_shardings(params: Dict[str, torch.Tensor], mesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a layer's MoE weights (:func:`moe_pspecs`)."""
    specs = moe_pspecs(mesh)
    return {k: shard_leaf(v, specs[k], mesh) for k, v in params.items()}


class TokenShard(NamedTuple):
    """Where a rank's tokens sit in the global batch: ``index`` [b·t], the
    global flat (b, t) index (``row · T + position``) of each local token
    in local order, of ``total`` = B·T tokens on ``mesh``."""
    mesh: Any
    index: torch.Tensor
    total: int


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-expert bucket size, rounded up to a multiple of 8 as the
    JAX package rounds it, so one capacity factor names the same buckets
    in both packages."""
    c = int(np.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(8, -(-c // 8) * 8)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot over the last axis, by comparison (CUDA's
    ``F.one_hot`` may check its indices on the host)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _global_stats(stats: torch.Tensor, n: int,
                  shard: Optional[TokenShard]) -> Tuple[torch.Tensor, int]:
    """The routing statistics' sums over the global batch and its token
    count: each rank's sums summed over dp and sp (identity backward)."""
    if shard is None:
        return stats, n
    return reduce_over(stats, shard.mesh, TOKEN_AXES), shard.total


def _routing(params, x, top_k: int, shard: Optional[TokenShard] = None):
    """Router probabilities, the renormalised top-k weights and experts
    (sorted by weight, descending), and the load-balancing loss
    E·Σ_e frac_tokens_e·frac_prob_e, taken on the routing decisions before
    any route is dropped, its means over the global batch.  All in
    float32."""
    E = params["router"].shape[1]
    logits = x.float() @ params["router"].float()            # [B,T,E]
    probs = torch.softmax(logits, -1)
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)        # [B,T,k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    routed = _one_hot(top_idx, E).any(2)                     # [B,T,E]
    stats = torch.cat([routed.float().sum((0, 1)), probs.sum((0, 1))])
    stats, n = _global_stats(stats, x.shape[0] * x.shape[1], shard)
    frac_tokens, frac_prob = (stats / n).split(E)
    aux = E * (frac_tokens * frac_prob).sum()
    return probs, top_p, top_idx, aux


def capacity_plan(experts: torch.Tensor, num_experts: int, capacity: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Bucket slots for the flat routes ``experts`` ([N·k], token-major).

    Returns ``(slot, valid, src, filled)``: route r takes slot
    ``slot[r] = e·C + pos`` where ``pos`` counts the earlier routes to its
    expert e, and is kept when ``valid[r]`` (pos < C; a dropped route's
    slot is E·C, as in the JAX package).  ``src[s]`` is the route that
    owns slot s and ``filled[s]`` whether any does.  A stable sort groups
    the routes by expert in route order: the c-th route of expert e sits
    at its group's start + c, and a route's pos is its place in the
    sorted order less its group's start.  (The JAX package's cumsum of a
    [N·k, E] one-hot down its long axis, a scan with E lanes, took 2.8 ms
    at N·k = 16,384 on an NVIDIA H100 80GB HBM3 at 700 W; the sorts take
    microseconds.)"""
    E, C = num_experts, capacity
    n = experts.shape[0]
    order = torch.argsort(experts, stable=True)
    counts = _one_hot(experts, E).sum(0)                      # [E]
    starts = counts.cumsum(0) - counts
    pos = torch.argsort(order) - starts[experts]
    valid = pos < C
    slot = torch.where(valid, experts * C + pos.clamp(max=C - 1), E * C)
    c = torch.arange(C, device=experts.device)
    src = order[(starts[:, None] + c).clamp(max=n - 1)].reshape(-1)
    filled = (c < counts[:, None]).reshape(-1)
    return slot, valid, src, filled


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            top_k: int = 2, compute_dtype=None, dispatch: str = "dense",
            capacity_factor: float = 1.25,
            shard: Optional[TokenShard] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, dim] → (out [B, T, dim] in x's dtype, aux loss, float32).

    ``"dense"``: every expert computes every token, weighted afterwards by
    the routing weights — exact, E/top_k times the useful products, the
    oracle the capacity schedule is tested against.  ``"capacity"``: each
    expert takes at most C = :func:`moe_capacity` routes into a bucket,
    the experts run as one batched product over ``[E, C, ·]``, and each
    token sums its surviving routes; a route past C loses that expert's
    contribution (its other routes and the residual still apply).

    With ``shard`` (a :class:`TokenShard`), ``x`` is this rank's tokens
    and ``params`` its shard (:func:`moe_shardings`): the result is the
    global layer's output at those tokens and its global aux loss."""
    if dispatch == "dense":
        return _moe_dense(params, x, top_k, compute_dtype, shard)
    if dispatch == "capacity":
        return _moe_capacity_dispatch(params, x, top_k, compute_dtype,
                                      capacity_factor, shard)
    raise ValueError(f"unknown moe dispatch '{dispatch}' "
                     "(expected dense|capacity)")


def _experts_here(params, shard: Optional[TokenShard]):
    """(mesh or None, this rank's first expert, its number of experts)."""
    mesh = None if shard is None else shard.mesh
    n = params["w1"].shape[0]
    first = 0 if mesh is None else mesh.index("ep") * n
    return mesh, first, n


def _moe_dense(params, x, top_k, compute_dtype, shard=None):
    dt = compute_dtype or x.dtype
    E = params["router"].shape[1]
    mesh, e0, n = _experts_here(params, shard)
    _, top_p, top_idx, aux = _routing(params, x, top_k, shard)
    # combine [B,T,E]: the routing weight per expert (0 where unrouted)
    combine = copy_to((_one_hot(top_idx, E) * top_p[..., None]).sum(2),
                      mesh, "ep")
    if n != E:
        combine = combine[..., e0:e0 + n]
    xc = copy_to(x.to(dt), mesh, "ep")
    gate = F.silu(torch.einsum("btd,edh->beth", xc, params["w1"].to(dt)))
    up = torch.einsum("btd,edh->beth", xc, params["w3"].to(dt))
    expert_out = torch.einsum("beth,ehd->betd", gate * up,
                              params["w2"].to(dt))            # [B,E,T,d]
    out = torch.einsum("betd,bte->btd", expert_out, combine.to(dt))
    return reduce_from(out, mesh, "ep").to(x.dtype), aux


def _global_plan(experts: torch.Tensor, num_experts: int, capacity: int,
                 top_k: int, shard: Optional[TokenShard]):
    """``capacity_plan`` of the global routes, for this rank's: ``(slot,
    valid)`` of each local route and ``(src, filled)`` of every slot,
    ``src`` a local route (a slot whose route is another rank's is not
    filled here).  The ranks' expert ids are gathered over dp and sp in
    the global token-major order, so every rank plans every bucket."""
    if shard is None:
        return capacity_plan(experts, num_experts, capacity)
    n = experts.shape[0]
    k = torch.arange(top_k, device=experts.device)
    where = (shard.index.to(experts.device)[:, None] * top_k + k).reshape(-1)
    total = shard.total * top_k
    every = gather_routes(experts, where, total, shard.mesh, TOKEN_AXES)
    slot, valid, src, filled = capacity_plan(every, num_experts, capacity)
    local = torch.full((total,), -1, dtype=torch.int64,
                       device=experts.device)
    local.index_copy_(0, where, torch.arange(n, device=experts.device))
    src = local[src]
    return slot[where], valid[where], src.clamp(min=0), filled & (src >= 0)


def _moe_capacity_dispatch(params, x, top_k, compute_dtype,
                           capacity_factor, shard=None):
    dt = compute_dtype or x.dtype
    B, T, D = x.shape
    N = B * T
    E = params["router"].shape[1]
    mesh, e0, n = _experts_here(params, shard)
    _, top_p, top_idx, aux = _routing(params, x, top_k, shard)
    C = moe_capacity(N if shard is None else shard.total, E, top_k,
                     capacity_factor)
    slot, valid, src, filled = _global_plan(top_idx.reshape(-1), E, C,
                                            top_k, shard)
    if n != E:          # this rank's experts' slots
        src, filled = src[e0 * C:(e0 + n) * C], filled[e0 * C:(e0 + n) * C]
        valid = valid & (slot >= e0 * C) & (slot < (e0 + n) * C)
        slot = slot - e0 * C

    # Fill the [E·C, D] buckets: each slot gathers its route's token.
    x_rep = copy_to(x, mesh, "ep").reshape(N, 1, D).expand(N, top_k, D)
    x_rep = x_rep.reshape(N * top_k, D).to(dt)                 # [N·k, D]
    xe = torch.where(filled[:, None], x_rep[src], 0).reshape(n, C, D)

    # The experts as one batched product chain over [E, C, ·].
    gate = F.silu(torch.bmm(xe, params["w1"].to(dt)))
    up = torch.bmm(xe, params["w3"].to(dt))
    ye = torch.bmm(gate * up, params["w2"].to(dt)).reshape(n * C, D)

    # Gather back, weight, and sum each token's surviving routes.
    top_p = copy_to(top_p, mesh, "ep")
    w = (top_p.reshape(-1) * valid.float()).to(dt)
    y_tok = ye[slot.clamp(0, n * C - 1)] * w[:, None]
    out = y_tok.reshape(N, top_k, D).sum(1).reshape(B, T, D)
    return reduce_from(out, mesh, "ep").to(x.dtype), aux
