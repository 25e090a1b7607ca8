"""Mixture-of-Experts feed-forward for the PyTorch port, on one device.

Port of ``multiverso_tpu/models/moe.py``: the router, the load-balancing
loss and the two dispatch schedules, over a dictionary of float32 master
weights (``router`` ``[dim, E]``, ``w1``/``w3`` ``[E, dim, hidden]``,
``w2`` ``[E, hidden, dim]``).  The JAX package runs all of it as XLA
einsums, gathers and scatters, outside any Pallas kernel, so here it is
plain PyTorch.  Expert parallelism (``moe_pspecs``/``moe_shardings``, the
``ep`` mesh axis) waits for ROADMAP.md Queue 1, "Several processes".

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

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["init_moe_params", "moe_capacity", "moe_ffn", "capacity_plan"]


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


def _routing(params, x, top_k: int):
    """Router probabilities, the renormalised top-k weights and experts
    (sorted by weight, descending), and the load-balancing loss
    E·Σ_e frac_tokens_e·frac_prob_e, taken on the routing decisions before
    any route is dropped.  All in float32."""
    E = params["router"].shape[1]
    logits = x.float() @ params["router"].float()            # [B,T,E]
    probs = torch.softmax(logits, -1)
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)        # [B,T,k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    routed = _one_hot(top_idx, E).any(2)                     # [B,T,E]
    frac_tokens = routed.float().mean((0, 1))
    frac_prob = probs.mean((0, 1))
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
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, dim] → (out [B, T, dim] in x's dtype, aux loss, float32).

    ``"dense"``: every expert computes every token, weighted afterwards by
    the routing weights — exact, E/top_k times the useful products, the
    oracle the capacity schedule is tested against.  ``"capacity"``: each
    expert takes at most C = :func:`moe_capacity` routes into a bucket,
    the experts run as one batched product over ``[E, C, ·]``, and each
    token sums its surviving routes; a route past C loses that expert's
    contribution (its other routes and the residual still apply)."""
    if dispatch == "dense":
        return _moe_dense(params, x, top_k, compute_dtype)
    if dispatch == "capacity":
        return _moe_capacity_dispatch(params, x, top_k, compute_dtype,
                                      capacity_factor)
    raise ValueError(f"unknown moe dispatch '{dispatch}' "
                     "(expected dense|capacity)")


def _moe_dense(params, x, top_k, compute_dtype):
    dt = compute_dtype or x.dtype
    E = params["router"].shape[1]
    _, top_p, top_idx, aux = _routing(params, x, top_k)
    # combine [B,T,E]: the routing weight per expert (0 where unrouted)
    combine = (_one_hot(top_idx, E) * top_p[..., None]).sum(2)
    xc = x.to(dt)
    gate = F.silu(torch.einsum("btd,edh->beth", xc, params["w1"].to(dt)))
    up = torch.einsum("btd,edh->beth", xc, params["w3"].to(dt))
    expert_out = torch.einsum("beth,ehd->betd", gate * up,
                              params["w2"].to(dt))            # [B,E,T,d]
    out = torch.einsum("betd,bte->btd", expert_out, combine.to(dt))
    return out.to(x.dtype), aux


def _moe_capacity_dispatch(params, x, top_k, compute_dtype,
                           capacity_factor):
    dt = compute_dtype or x.dtype
    B, T, D = x.shape
    N = B * T
    E = params["router"].shape[1]
    _, top_p, top_idx, aux = _routing(params, x, top_k)
    C = moe_capacity(N, E, top_k, capacity_factor)
    slot, valid, src, filled = capacity_plan(top_idx.reshape(-1), E, C)

    # Fill the [E·C, D] buckets: each slot gathers its route's token.
    x_rep = x.reshape(N, 1, D).expand(N, top_k, D).reshape(N * top_k, D)
    x_rep = x_rep.to(dt)                                       # [N·k, D]
    xe = torch.where(filled[:, None], x_rep[src], 0).reshape(E, C, D)

    # The experts as one batched product chain over [E, C, ·].
    gate = F.silu(torch.bmm(xe, params["w1"].to(dt)))
    up = torch.bmm(xe, params["w3"].to(dt))
    ye = torch.bmm(gate * up, params["w2"].to(dt)).reshape(E * C, D)

    # Gather back, weight, and sum each token's surviving routes.
    w = (top_p.reshape(-1) * valid.float()).to(dt)
    y_tok = ye[slot.clamp(max=E * C - 1)] * w[:, None]
    out = y_tok.reshape(N, top_k, D).sum(1).reshape(B, T, D)
    return out.to(x.dtype), aux
