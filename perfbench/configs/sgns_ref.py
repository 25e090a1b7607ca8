"""Plain reference of skip-gram with negative sampling over two tables.

One step on a batch of (center, context, negatives): the loss
-(log σ(u_o·v_c) + Σ_n log σ(-u_n·v_c)), averaged over the batch, its
gradients written out by hand, and plain SGD applied row by row with
duplicate rows summed (``index_add_``): ``w_in[c] -= lr·dv_c``,
``w_out[o] -= lr·du_o``, ``w_out[n] -= lr·du_n``.  Float32, written from
the configuration alone; it imports nothing of the program and takes
only the tables and batches the benchmark made.

``precision="tf32"`` is the control: every product's operands are
rounded to TF32 (10 mantissa bits, to nearest) before it, as the card's
TF32 matrix products round them, and summed in float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

TABLES = ("in", "out")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits, to nearest (ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def norm64(x: torch.Tensor) -> float:
    """The 2-norm summed in float64, so that it resolves gaps far below
    float32's rounding of a large sum."""
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def sgns_step(w_in, w_out, c, o, neg, lr: float, precision: str = "fp32"
              ) -> float:
    """One step, in place; returns the loss."""
    rnd = _tf32 if precision == "tf32" else (lambda t: t)
    B, K = neg.shape
    vc, uo, un = w_in[c], w_out[o], w_out[neg]
    pos = (rnd(vc) * rnd(uo)).sum(-1)
    negs = (rnd(un) * rnd(vc)[:, None, :]).sum(-1)
    loss = -(F.logsigmoid(pos).sum() + F.logsigmoid(-negs).sum()) / B
    gp = (torch.sigmoid(pos) - 1) / B          # d loss / d pos
    gn = torch.sigmoid(negs) / B               # d loss / d neg
    dvc = rnd(gp)[:, None] * rnd(uo) + (rnd(gn)[..., None] * rnd(un)).sum(1)
    duo = rnd(gp)[:, None] * rnd(vc)
    dun = rnd(gn)[..., None] * rnd(vc)[:, None, :]
    w_in.index_add_(0, c, dvc, alpha=-lr)
    w_out.index_add_(0, torch.cat([o, neg.reshape(-1)]),
                     torch.cat([duo, dun.reshape(B * K, -1)]), alpha=-lr)
    return float(loss)


def train(w_in: torch.Tensor, w_out: torch.Tensor,
          batches: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
          lr: float, precision: str = "fp32") -> dict:
    """SGD over ``batches`` from the tables given (trained in place): the
    loss of each step, each table's first gradient norm and each table's
    change after the last step (norms in float64)."""
    start = {"in": w_in.clone(), "out": w_out.clone()}
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for i, (c, o, neg) in enumerate(batches):
        losses.append(sgns_step(w_in, w_out, c, o, neg, lr, precision))
        if i == 0:
            grad = {"in": norm64(start["in"] - w_in) / lr,
                    "out": norm64(start["out"] - w_out) / lr}
    change = {"in": norm64(w_in - start["in"]),
              "out": norm64(w_out - start["out"])}
    return {"loss": losses, "grad": grad, "change": change}
